"""snail_tpu_torch — the PyTorch + CUDA port of ``snail_tpu``.

The package mirrors ``snail_tpu``'s module names so each piece can be read
beside its JAX counterpart:

- ``core``   — constants and the Camera / Light / RenderOpts records;
- ``bvh``    — the NumPy SAH builder and its disk cache;
- ``scene``  — NumPy scene assembly (procedural scenes, the OBJ/MTL,
  Doom 3 and Desperados 2 loaders, flattening, the material table, the
  texture atlases), the device scene (:class:`TracedScene`, and the
  one-call ``load_scene``), the texture samplers and rigid instances of
  one base scene (``scene.instancing``);
- ``ops``    — the traversal: host-side packing, the plain PyTorch versions
  of the kernels and the wrappers that launch the hand-written CUDA
  kernels in ``csrc/`` for tensors on a CUDA device;
- ``render`` — the packed Whitted frames (forward, bounces, gradients,
  counters), the frame renderer and photon mapping;
- ``volume`` — the volume loaders (raw, DICOM), the min/max brick pyramid
  and its march (a CUDA kernel on the card), iso and MIP views;
- ``net``    — the tile codec (the native LZ of ``native/codec.cpp``)
  and the client/server frame protocol, host code;
- ``apps``   — the render server, its client, the standalone renderer
  ``rtracer`` and the DICOM viewer;
- ``parallel`` — frames and training steps split over the ranks of a
  ``torch.distributed`` process group, one device per process;
- ``utils``  — the traversal counters' ``TreeStats`` record, the frame
  counter and image IO.

Nothing here imports JAX or ``snail_tpu``: what the port needs of the JAX
package's NumPy host code it keeps as its own copy, which the CPU tests
hold equal to the original (the BVH builder and cache, the procedural
scenes, the loaders, the material table, the texture tables, the codec
and the protocol), so a triangle id means the same in both.
Entry points build on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
