"""Volume rendering (``snail_tpu.volume``, the reference's DICOM viewer
stack: src/vtree.{h,cpp}, src/volume_data.*, src/dicom_viewer.cpp,
src/vrender_opengl.cpp): the NumPy loaders, the min/max pyramid and the
march, one CUDA kernel on the card (``ops.march``)."""

from .data import VolumeData, load_dicom_dir, load_dicom_file, load_raw
from .vtree import VTree, build_vtree, render_volume

__all__ = [
    "VolumeData", "load_dicom_dir", "load_dicom_file", "load_raw",
    "VTree", "build_vtree", "render_volume",
]
