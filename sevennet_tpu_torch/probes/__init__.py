"""Hopper probes: the TPU probe kernels of ``scripts_dev/`` as hand-written
CUDA kernels, each with a plain PyTorch version of its contract and a timing
function that follows the TPU script's method (:mod:`.mm_rate`,
:mod:`.batched_dot`, :mod:`.fma_rate`, :mod:`.gather`, :mod:`.reduce`,
:mod:`.xpose`, :mod:`.fold`, :mod:`.fold_conv`, :mod:`.breakdown`,
:mod:`.knockout`). They measure the
ingredients of the conv kernels' design on the card; no model path calls
them."""
