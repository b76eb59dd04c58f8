"""Fused operators over the hand-written kernels of `native/`:
`ops.flash_attention`, and the quantized products of `ops.fp8` (fp8
training matmuls) and `ops.int8` (int8 products on quantized weights)."""
