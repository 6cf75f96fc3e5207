"""snail_tpu_torch — the PyTorch + CUDA port of ``snail_tpu``.

The package mirrors ``snail_tpu``'s module names so each piece can be read
beside its JAX counterpart:

- ``core``   — constants and the Camera / Light / RenderOpts records;
- ``scene``  — NumPy scene assembly (procedural scenes, flattening, the
  default material table) and the device scene (:class:`TracedScene`);
- ``ops``    — the traversal: host-side packing, the plain PyTorch versions
  of the kernels and the wrappers that launch the hand-written CUDA
  kernels in ``csrc/`` for tensors on a CUDA device;
- ``render`` — the packed Whitted forward frame and the frame renderer.

The one import taken from ``snail_tpu`` is ``snail_tpu.bvh`` (NumPy only),
so both packages share one BVH and a triangle id means the same in both.
Nothing here imports JAX.
"""

__version__ = "0.1.0"
