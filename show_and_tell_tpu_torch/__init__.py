"""show_and_tell_tpu_torch: Show-Attend-Tell captioning in PyTorch, with
hand-written CUDA kernels for Hopper (sm_90a).

A port of the JAX package ``show_and_tell_tpu``, which stays the reference.
This package imports nothing of JAX or of the JAX package. Its entry points
run on the GPU unless the caller passes ``device="cpu"``; on CPU tensors the
kernels' plain PyTorch versions run instead.
"""
