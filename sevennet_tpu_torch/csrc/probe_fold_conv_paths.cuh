// The instruction shapes of the conv fold kernel (probe_fold_conv.cu): path id,
// x components d1, output components d3, and bit m d3 + p set where the pair
// (m, p) has a Wigner row. Written by probes/fold_conv.py:path_header();
// tests/test_torch_probe_plans.py holds this file to it.
#pragma once

#define FC_NPATH 15
#define FC_PATHS(X) \
  X(0, 1, 1, 0x1ull) \
  X(1, 3, 1, 0x7ull) \
  X(2, 5, 1, 0x1full) \
  X(3, 1, 3, 0x7ull) \
  X(4, 3, 3, 0x111ull) \
  X(5, 3, 3, 0xeeull) \
  X(6, 3, 3, 0x1ffull) \
  X(7, 5, 3, 0x5dddull) \
  X(8, 5, 3, 0x7f7full) \
  X(9, 1, 5, 0x1full) \
  X(10, 3, 5, 0x75d7ull) \
  X(11, 3, 5, 0x7f7full) \
  X(12, 5, 5, 0x1041041ull) \
  X(13, 5, 5, 0xbbabbaull) \
  X(14, 5, 5, 0x1efffefull)
