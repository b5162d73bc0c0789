// Knock-out probe of the emb/sh fused conv forward: the variants of
// scripts_dev/r3_fwd_knockout.py:make (pallas_call at :128, kernel
// :50-116), all at HIGHEST (3xTF32 here): full (B4 fwd itself), nomlp (w =
// 0.1 emb[:, 0], no MLP layer), notp (no uvu product: w[0, 0] + tmp[0, 0]
// broadcast), nofold (per-edge messages, slot 0 stored, no K sum) and
// nothing (nomlp and notp). The kernel and the mapping of each variant:
// probe_breakdown.cuh.
#include "probe_breakdown.cuh"

PB_ENTRY(probe_knockout_launch, PB_CASE(PB_KO_FULL) PB_CASE(PB_KO_NOMLP) PB_CASE(PB_KO_NOTP)
                                    PB_CASE(PB_KO_NOFOLD) PB_CASE(PB_KO_NOTHING))
