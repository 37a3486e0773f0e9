"""Command-line drivers (port of the JAX package's cli.py), installed as
``cylpose-torch``:

  undistort-folder  undistort every image of a folder by the camera its
                    name picks ('L' in the stem: left, else right) and
                    write "<name>_undistorted.png" (ref utils/iotool.py:41-72);
                    an unreadable image is reported and skipped.
  detect-folder     the python_grid_detection_{cylinder,plane}.py batch
                    driver (ref python_grid_detection_cylinder.py:12-64):
                    undistort, detect the grid, write "<name>_arc.png"
                    overlays and processed_images_data.json.  Same-shape
                    frames run in chunks of ``--chunk`` (the last padded),
                    ceil(N / chunk) detector calls; a failing image or chunk
                    is recorded as an error and the rest go on.
  experiment        the exp_gridDetection.m pipeline: stereo basenames,
                    pan/tilt from the names, preprocessing, detect + fit per
                    frame, then the camera <-> AGV registration; prints the
                    reference's per-frame "average error = a -> b mm" lines
                    (ref utils/fitSingleCylinder.m:28).

Every command takes ``--device`` (default ``cuda``).  PNG files are read
and written by ``utils/png.py``; Pillow is needed only for .jpg and .bmp
inputs, matplotlib only for ``experiment --output``'s fvals.png.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import List, Optional, Tuple

import numpy as np

IMAGE_SUFFIXES = (".png", ".jpg", ".bmp")


def _progress(it, desc: str):
    """tqdm when it is installed (the reference uses tqdm: ref
    python_grid_detection_cylinder.py:32), the plain iterable otherwise."""
    try:
        from tqdm import tqdm
    except ImportError:
        return it
    return tqdm(it, desc=desc)


def load_image(path: str) -> np.ndarray:
    """A grey (H, W) float32 image: PNGs through ``utils/png.py``, other
    formats through Pillow's ``convert("L")`` (the same luma)."""
    from cylinder_pose_estimation_tpu_torch.utils import png

    if path.lower().endswith(".png"):
        return png.to_luma(png.read_png(path)).astype(np.float32)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{os.path.basename(path)}: reading this format needs Pillow, which is not "
                           "installed (PNG files need nothing)") from e
    return np.asarray(Image.open(path).convert("L"), np.float32)


def save_image(path: str, arr: np.ndarray) -> None:
    """Write an image clipped to [0, 255] as an 8-bit PNG."""
    from cylinder_pose_estimation_tpu_torch.utils.png import write_png

    write_png(path, np.clip(arr, 0, 255).astype(np.uint8))


def parse_img_info(name: str) -> Optional[Tuple[float, float]]:
    """'<pan><tilt>' degrees from a basename (ref utils/parseImgInfo.m:16-30,
    regex ^(-?\\d+)(-?\\d+)$).  The first group is greedy, as in the
    reference: '1010' reads (101, 0); signed or single-digit tilts
    ('10-20', '-15-5', '175') read as meant."""
    m = re.match(r"^(-?\d+)(-?\d+)$", name)
    if not m:
        return None
    return float(m.group(1)), float(m.group(2))


def unique_basenames(folder: str) -> List[str]:
    """Basenames of the '*L.png' images, sorted (ref utils/getUniqueName.m)."""
    return [f[:-5] for f in sorted(os.listdir(folder)) if f.endswith("L.png")]


def _image_files(folder: str) -> List[str]:
    return [f for f in sorted(os.listdir(folder)) if f.lower().endswith(IMAGE_SUFFIXES)]


def _batched_detect_runner(stereo, cfg):
    """One chunk program: undistort each frame by its camera, then detect
    the chunk as one batch.  On a CUDA device it is one compiled step (the
    JAX CLI's ``@jax.jit run``): the first chunk runs eagerly, the second
    captures a CUDA graph, replayed for every later chunk of the same shape
    (the tail chunk is padded to it), its outputs cloned.  Module-level so tests can count the
    calls."""
    import torch

    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
    from cylinder_pose_estimation_tpu_torch.ops.remap import undistort_image

    stereo = pipeline._stereo_copy(stereo)
    key = ("detect-folder", cfg, pipeline._stereo_key(stereo))

    def body(imgs, is_left):
        with torch.inference_mode():
            und = torch.where(is_left[:, None, None], undistort_image(imgs, stereo.cam1),
                              undistort_image(imgs, stereo.cam2))
            return detect_grid(und, cfg), und

    def run(imgs, is_left):
        return pipeline._compiled(key, body, (imgs, is_left), fresh=True)

    return run


def cmd_detect_folder(args) -> None:
    """Batch detection."""
    import torch

    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, PlaneDetectConfig
    from cylinder_pose_estimation_tpu_torch.types import GridPoints
    from cylinder_pose_estimation_tpu_torch.utils.io import grid_points_to_json, load_stereo_json
    from cylinder_pose_estimation_tpu_torch.utils.viz import overlay_detection

    device = torch.device(args.device)
    stereo = load_stereo_json(args.camera_json, device=device)
    files = _image_files(args.input)
    if not files:
        print("no images found")
        return
    os.makedirs(args.output, exist_ok=True)
    chunk = max(1, int(args.chunk))

    results = {}
    # Load with per-image isolation; one group per image shape.
    groups: dict = {}
    for f in files:
        try:
            img = load_image(os.path.join(args.input, f))
        except Exception as e:  # one unreadable image must not stop the folder
            results[f] = {"error": str(e)}
            continue
        groups.setdefault(img.shape, []).append((f, img))

    cfg_cls = CylinderDetectConfig if args.mode == "cylinder" else PlaneDetectConfig
    for (h, w), items in groups.items():
        run = _batched_detect_runner(stereo, cfg_cls(height=h, width=w))
        for start in _progress(range(0, len(items), chunk), f"detect {h}x{w}"):
            part = items[start:start + chunk]
            n = len(part)
            imgs = np.stack([im for _, im in part] + [np.zeros((h, w), np.float32)] * (chunk - n))
            # 'L' in the file name selects the left camera (ref :36-41).
            is_left = np.asarray(["L" in os.path.splitext(f)[0] for f, _ in part] + [True] * (chunk - n))
            try:
                res, und = run(torch.as_tensor(imgs, device=device), torch.as_tensor(is_left, device=device))
                grid = GridPoints(*(x.cpu() for x in res.grid))
                und = und.cpu().numpy()
            except Exception as e:  # a failing chunk marks its images
                for f, _ in part:
                    results[f] = {"error": str(e)}
                continue
            for i, (f, _) in enumerate(part):
                try:
                    gp = GridPoints(*(x[i] for x in grid))
                    results[f] = json.loads(grid_points_to_json(gp))
                    overlay_detection(und[i], gp, path=os.path.join(
                        args.output, os.path.splitext(f)[0] + "_arc.png"))
                except Exception as e:
                    results[f] = {"error": str(e)}
    out_json = os.path.join(args.output, "processed_images_data.json")
    with open(out_json, "w") as fp:
        json.dump(results, fp, indent=2)
    print("wrote", out_json)


def cmd_experiment(args) -> None:
    """The whole experiment."""
    import torch

    from cylinder_pose_estimation_tpu_torch.config import (
        CylinderDetectConfig,
        FitConfig,
        RegistrationConfig,
    )
    from cylinder_pose_estimation_tpu_torch.models.pipeline import (
        compiled_batch,
        frame_health,
        preprocess_stereo_batch,
        register_sequence,
    )
    from cylinder_pose_estimation_tpu_torch.ops.remap import undistort_image
    from cylinder_pose_estimation_tpu_torch.utils.io import load_stereo_json

    device = torch.device(args.device)
    stereo = load_stereo_json(args.camera_json, device=device)
    names = unique_basenames(args.input)
    if len(names) < 2:
        print("need >= 2 stereo pairs")
        return
    angles, imgs1, imgs2, used_names = [], [], [], []
    for n in names:
        info = parse_img_info(n)
        if info is None:
            continue
        imgs1.append(load_image(os.path.join(args.input, n + "L.png")))
        imgs2.append(load_image(os.path.join(args.input, n + "R.png")))
        angles.append([np.deg2rad(info[0]), np.deg2rad(info[1])])
        used_names.append(n)
    h, w = imgs1[0].shape
    cfg = CylinderDetectConfig(height=h, width=w)
    fit_cfg = FitConfig(cyl_radius=args.radius)
    reg_cfg = RegistrationConfig(cyl_radius=args.radius)

    a = torch.as_tensor(np.stack(imgs1), device=device)
    b = torch.as_tensor(np.stack(imgs2), device=device)
    if args.no_clahe:
        # Undistortion only (no adapthisteq equalisation).
        with torch.inference_mode():
            a, b = undistort_image(a, stereo.cam1), undistort_image(b, stereo.cam2)
    else:
        # Undistortion + adaptive histogram equalisation of both views
        # (ref utils/preProcessing.m:4-21).
        a, b = preprocess_stereo_batch(a, b, stereo)
    # Poses and registration: two compiled steps on a CUDA device (the
    # preprocessing above runs eagerly).
    batch = compiled_batch(stereo, cfg, fit_cfg)(a, b)
    reg = register_sequence(batch, torch.as_tensor(np.asarray(angles, np.float32), device=device), reg_cfg)
    fvals = batch.fit.fvals.cpu().numpy()
    for i, n in enumerate(used_names):
        # ref utils/fitSingleCylinder.m:28 print format
        print(f"{i + 1}-th image [{n}]: average error = "
              f"{np.sqrt(fvals[i, 0]):.6g} -> {np.sqrt(fvals[i, 1]):.6g} mm")
    print(f"registration fval: {float(reg.fval0):.6g} -> {float(reg.fval):.6g}")
    healthy = int(frame_health(batch, reg_cfg).sum())
    print(f"registration: {healthy} of {len(used_names)} frames healthy, min eigenvalue "
          f"{float(reg.jtj_min_eig):.6g}, well posed {bool(reg.well_posed)}")
    t = reg.t_cam_agv.cpu().numpy()
    print("T_Cam_AGV =\n", t)
    if args.output:
        from cylinder_pose_estimation_tpu_torch.utils.viz import plot_fvals

        os.makedirs(args.output, exist_ok=True)
        plot_fvals(fvals, os.path.join(args.output, "fvals.png"))
        np.save(os.path.join(args.output, "T_cam_agv.npy"), t)
        print("wrote", args.output)


def cmd_undistort_folder(args) -> None:
    """Undistort a folder."""
    import torch

    from cylinder_pose_estimation_tpu_torch.ops.remap import undistort_image
    from cylinder_pose_estimation_tpu_torch.utils.io import load_stereo_json

    device = torch.device(args.device)
    stereo = load_stereo_json(args.camera_json, device=device)
    os.makedirs(args.output, exist_ok=True)
    written = 0
    for f in _progress(_image_files(args.input), "undistort"):
        try:
            img = torch.as_tensor(load_image(os.path.join(args.input, f)), device=device)
        except Exception as e:  # one unreadable image must not stop the folder
            print(f"skipped {f}: {e}")
            continue
        cam = stereo.cam1 if "L" in os.path.splitext(f)[0] else stereo.cam2
        with torch.inference_mode():
            out = undistort_image(img, cam).cpu().numpy()
        save_image(os.path.join(args.output, os.path.splitext(f)[0] + "_undistorted.png"), out)
        written += 1
    print("wrote", written, "images to", args.output)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cylpose-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--camera-json", required=True)
        sp.add_argument("--input", required=True)
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; 'cpu' runs the plain versions)")

    u = sub.add_parser("undistort-folder", help="undistort a folder of images")
    common(u)
    u.add_argument("--output", required=True)
    u.set_defaults(fn=cmd_undistort_folder)

    d = sub.add_parser("detect-folder", help="batch grid detection over a folder")
    common(d)
    d.add_argument("--output", required=True)
    d.add_argument("--mode", choices=["cylinder", "plane"], default="cylinder")
    d.add_argument("--chunk", type=int, default=16,
                   help="frames per batched detector call (the last chunk is padded)")
    d.set_defaults(fn=cmd_detect_folder)

    e = sub.add_parser("experiment", help="full stereo pose + AGV registration")
    common(e)
    e.add_argument("--output", default=None)
    e.add_argument("--radius", type=float, default=45.0)
    e.add_argument("--no-clahe", action="store_true",
                   help="skip adaptive histogram equalisation (ref preProcessing.m does it)")
    e.set_defaults(fn=cmd_experiment)
    return p


def main(argv=None) -> None:
    """Console entry point of ``cylpose-torch``."""
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
