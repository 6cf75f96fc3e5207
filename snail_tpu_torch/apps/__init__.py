"""Entry-point applications (``snail_tpu.apps``, the rebuild of the
reference's binaries, SURVEY.md section 2.5): the render server
(``python -m snail_tpu_torch.apps.server``), its viewer client
(``apps.client``), the standalone renderer (``apps.rtracer``) and the
DICOM viewer (``apps.dicom_viewer``). Each renders on the card unless
``--device cpu`` is given (the client renders nothing itself)."""
