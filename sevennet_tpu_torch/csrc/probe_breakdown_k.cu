// Breakdown probe of the emb/sh fused conv forward, part 2: the K-sum
// variants of scripts_dev/r2_fused_breakdown.py:build (pallas_call at :170)
// that its "k" and "mm" runs time (:383-390), at default precision (one
// TF32 pass in the MLP, W3 and tmp here): tpredk, storek, fullk (the kred
// halving chain), tpredmm (tpredmm_amaj is the same function at one
// receiver a step) and fullmm (the 0/1 product). The kernel and the mapping
// of each variant: probe_breakdown.cuh.
#include "probe_breakdown.cuh"

PB_ENTRY(probe_breakdown_k_launch, PB_CASE(PB_TPREDK) PB_CASE(PB_STOREK) PB_CASE(PB_FULLK)
                                       PB_CASE(PB_TPREDMM) PB_CASE(PB_FULLMM))
