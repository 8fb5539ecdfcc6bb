"""Hand-written Hopper kernels of the port, their wrappers and their plain
PyTorch versions.

  ``csrc/``             CUDA C++ sources with a plain C interface.
  ``build``             nvcc into ``build/kernels/`` and ctypes loading.
  ``flash_attention``   the flash forward and backward wrappers (launch
                        counters).
  ``fused_update``      the fused momentum update + prediction wrapper.
  ``rwkv6_scan``        the RWKV-6 WKV recurrence wrapper.
  ``mamba2_scan``       the Mamba-2 SSD recurrence wrapper.
  ``ops``               model-side entry points (the differentiable
                        flash attention, the two recurrences), the
                        launch counters and the timing hook.
  ``ref``               plain PyTorch versions (CPU path and oracles).
"""
