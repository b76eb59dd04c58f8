"""Fused operators over the hand-written kernels of `native/`
(`ops.flash_attention`)."""
