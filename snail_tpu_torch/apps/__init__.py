"""Entry-point applications (``snail_tpu.apps``, the rebuild of the
reference's binaries, SURVEY.md section 2.5). So far the DICOM viewer,
``python -m snail_tpu_torch.apps.dicom_viewer``."""
