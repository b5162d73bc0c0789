// Breakdown probe of the emb/sh fused conv forward, part 1: the phase
// variants of scripts_dev/r2_fused_breakdown.py:build (pallas_call at :170,
// kernel :59-157) that its "all" and "time" runs time (:363-382): mlp at
// default precision (one TF32 pass here) and at HIGHEST (3xTF32), tmp, tp,
// tpred, full at default precision and at HIGHEST, the last B4 fwd itself.
// The kernel and the mapping of each variant: probe_breakdown.cuh.
#include "probe_breakdown.cuh"

PB_ENTRY(probe_breakdown_launch, PB_CASE(PB_MLP) PB_CASE(PB_MLP_HI) PB_CASE(PB_TMP) PB_CASE(PB_TP)
                                     PB_CASE(PB_TPRED) PB_CASE(PB_FULL) PB_CASE(PB_FULL_HI))
