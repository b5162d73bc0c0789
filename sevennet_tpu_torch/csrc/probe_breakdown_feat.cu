// Breakdown probe of the emb/sh fused conv forward, part 3: the
// feature-major kernels of scripts_dev/r2_fused_breakdown.py, build_feat
// (pallas_call at :262; full, its K sum a 0/1 product at HIGHEST, and
// transpose, defined there but never called) and build_featroll
// (pallas_call at :343; full, its K sum a roll halving chain, also the A 32
// run at :437, and mlp_only), all at HIGHEST (3xTF32 here). The tiles x, w
// and tmp are stored (features, TE), rows 20 floats apart. The kernel and
// the mapping of each variant: probe_breakdown.cuh.
#include "probe_breakdown.cuh"

PB_ENTRY(probe_breakdown_feat_launch, PB_CASE(PB_FEAT_FULL) PB_CASE(PB_FEAT_TRANSPOSE)
                                          PB_CASE(PB_FEATROLL_FULL) PB_CASE(PB_FEATROLL_MLP))
