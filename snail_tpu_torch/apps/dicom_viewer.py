"""DICOM volume viewer (``snail_tpu.apps.dicom_viewer``, the reference's
src/dicom_viewer.cpp): loads a DICOM slice directory or a raw u16 volume,
builds the min/max brick pyramid and renders an iso or MIP view to a PNG.

    python -m snail_tpu_torch.apps.dicom_viewer DIR --mode iso --iso 0.05
    python -m snail_tpu_torch.apps.dicom_viewer vol.raw --raw-shape 64,64,64

It renders on the card (the march kernel, ``ops.march``) unless
``--device cpu`` asks for the plain version.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.types import Camera, resolve_device
from ..volume import build_vtree, load_dicom_dir, load_raw, render_volume


def viewer_camera(shape, device="cuda") -> Camera:
    """The viewer's camera on a volume of ``shape`` (D, H, W): from above
    one corner, looking at the centre (world xyz = voxel space)."""
    d, h, w = shape
    center = np.array([w, h, d], np.float64) * 0.5
    pos = center + np.array([0.9, 0.35, 0.45]) * max(d, h, w) * 1.6
    return Camera.look_at(pos=tuple(pos), target=tuple(center),
                          device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="snail_tpu_torch DICOM viewer")
    ap.add_argument("path", help="DICOM directory or .raw file")
    ap.add_argument("--raw-shape", default=None,
                    help="D,H,W when loading a raw u16 volume")
    ap.add_argument("--res", default="512x512")
    ap.add_argument("--mode", choices=("iso", "mip"), default="iso")
    ap.add_argument("--iso", type=float, default=0.05)
    ap.add_argument("--out", default="dicom_view.png")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.raw_shape:
        shape = tuple(map(int, args.raw_shape.split(",")))
        vd = load_raw(args.path, shape)
    else:
        vd = load_dicom_dir(args.path)
    print(f"[dicom] volume {vd.shape} spacing {vd.spacing}", flush=True)

    vt = build_vtree(vd, device=device)
    resx, resy = map(int, args.res.split("x"))
    img = render_volume(vt, viewer_camera(vd.shape, device), resx, resy,
                        iso=args.iso, mode=args.mode).cpu().numpy()
    from ..utils.image import save_image

    save_image(args.out, img)
    print(f"[dicom] wrote {args.out} (mean {img.mean():.4f})", flush=True)


if __name__ == "__main__":
    main()
