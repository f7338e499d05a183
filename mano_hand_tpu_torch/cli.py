"""Command-line interface of the port: ``python -m mano_hand_tpu_torch``.

The offline subcommands of the JAX package's ``cli.py``, with its flags,
messages and exit codes, on the port:

  demo     export the reference demo's mesh (OBJ pair, or binary PLY)
  convert  convert an asset between formats (.npz canonical, dumped .pkl)
  animate  batch-evaluate a pose sequence ([T, 16, 3] .npy) and write OBJ
           frames, or one animated GLB (morph targets or a skin)
  render   rasterise a pose (or a pose sequence) to PNG frames, a GIF or
           an AVI with the port's z-buffer renderer
  fit      recover pose/shape from target vertices, 3D joints, 2D
           keypoints, scan points, a segmentation mask or a depth image
           (Adam or Levenberg-Marquardt); writes a .npz checkpoint and,
           with --heatmap, a per-vertex error render (PNG or GLB)
  export-aot  export the forward (``torch.export``, params baked in) as
           a self-contained artifact for ``io.export_aot.load_forward``
  info     print an asset's schema summary
  verify   audit an asset and print its canonical digests
  trace-report  summarize a ``torch.profiler`` capture and/or an engine
           span export into one host+device report
           (``obs/trace_report.py``)
  serve-bench  drive the serving engine with a synthetic request stream,
           or one of its drills, and print one JSON line of metrics
  serve    serve the engine over the edge wire protocol (``edge/``)
  proxy    one member of the active/standby fleet proxy pair
           (``edge/proxy.py`` behind a flock on a fixed service port)
  status   host and device health, goldens, a live edge worker, the last
           persisted metrics scrape (one JSON document)
  analyze  the port's static analysis (``analysis/``): policy linter,
           lock-discipline checker, FX program auditor; exit 0 iff clean

``--device {cuda,cpu}`` (default ``cuda``) picks the device every
subcommand runs on, where the JAX CLI takes ``--platform``; ``demo
--backend`` is ``np`` (the float64 oracle) or ``torch``. ``export-aot``
exports for its own ``--platforms`` (device types, default ``cpu``), and
``status`` probes its own ``--platforms`` (``cpu``, ``cuda``, ``default``).
``analyze`` always traces on the CPU (JAX's ``--platform`` goes) and
takes ``--skip-fx`` where JAX's takes ``--skip-jaxpr``.
``serve`` and ``serve-bench`` without a card exit 2 unless ``--device
cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from mano_hand_tpu_torch.utils.arrays import as_numpy

# The reference demo's hardcoded inputs: data constants, reproduced so
# `demo` output is comparable against the reference's hand.obj.
DEMO_POSE_PCA = np.array([
    -0.32322194, 0.740878, -1.182191, 1.51246975, -1.89044963,
    0.68187004, -0.33078079, 0.23475931, -1.43845225,
])
DEMO_SHAPE = np.array([
    -0.33191198, 0.88129797, -1.9995425, -0.79066971, -1.41297644,
    -1.63064562, -1.25495915, -0.61775709, -0.4129301, 0.15526694,
])
DEMO_GLOBAL_ROT = np.array([1.0, 0.0, 0.0])

SIDES = [None, "left", "right", "neutral"]


def _load_params(spec: str, side: str | None = None, device=None):
    """An asset path, or ``synthetic`` (seed 0), in float64 on ``device``."""
    from mano_hand_tpu_torch.assets import load_model, synthetic_params

    if spec == "synthetic":
        return synthetic_params(seed=0, side=side or "right", device=device)
    return load_model(spec, side=side, device=device)


def cmd_demo(args) -> int:
    from mano_hand_tpu_torch.models.layer import MANOModel

    params = _load_params(args.asset, args.side, "cpu")
    model = MANOModel(params, backend=args.backend, device=args.device)
    model.set_params(
        pose_pca=DEMO_POSE_PCA, shape=DEMO_SHAPE, global_rot=DEMO_GLOBAL_ROT
    )
    if str(args.out).lower().endswith(".ply"):
        model.export_ply(args.out)
        print(f"wrote {args.out} (binary PLY), backend={args.backend}")
    else:
        model.export_obj(args.out)
        print(f"wrote {args.out} (+ restpose twin), backend={args.backend}")
    return 0


def cmd_convert(args) -> int:
    from mano_hand_tpu_torch.assets import (
        load_model, save_dumped_pickle, save_npz,
    )

    try:
        params = load_model(args.src, side=args.side, device=args.device)
    except Exception as e:
        print(f"cannot load asset {args.src}: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    note = ""
    dst = Path(args.dst)
    if args.mirror:
        from mano_hand_tpu_torch.assets import mirror_params

        params = mirror_params(params)
        note = f" (mirrored -> {params.side})"
        if (dst.suffix == ".pkl"
                and params.side not in dst.name.lower()):
            # The nine-key dumped-pickle format has no side field; the
            # loader re-infers side from the filename, so a mirrored
            # pickle without it would round-trip as the wrong hand.
            print(f"--mirror to .pkl needs the side in the filename "
                  f"(dumped pickles carry no side field): name it "
                  f"*{params.side}*.pkl or write .npz", file=sys.stderr)
            return 2
    if dst.suffix == ".npz":
        save_npz(params, dst)
    elif dst.suffix == ".pkl":
        save_dumped_pickle(params, dst)
    else:
        print(f"unsupported output format: {dst.suffix}", file=sys.stderr)
        return 2
    print(f"converted {args.src} -> {dst}{note}")
    return 0


def _load_pose_sequence(path: str | None, params) -> np.ndarray:
    """Pose bank -> [T, n_joints, 3]. Accepts [T, 16, 3], [T, 15, 3] (a
    zero global-rotation row prepended, as the reference's viewer loop
    does), or a single [16, 3]/[15, 3] pose; None gives one rest-pose
    frame."""
    if path is None:
        return np.zeros((1, params.n_joints, 3))
    poses = np.load(path)
    if poses.ndim == 2:
        poses = poses[None]
    if poses.shape[-2] == params.n_joints - 1:
        poses = np.concatenate(
            [np.zeros((*poses.shape[:-2], 1, 3)), poses], axis=-2
        )
    return poses


def _forward_clip(params, poses: np.ndarray):
    """The batched forward of a pose clip (zero shape) on the params'
    device."""
    from mano_hand_tpu_torch.models import core

    dev = params.device
    with torch.no_grad():
        return core.forward_batched(
            params, torch.as_tensor(poses, dtype=torch.float32, device=dev),
            torch.zeros((poses.shape[0], params.n_shape), dtype=torch.float32,
                        device=dev))


def cmd_animate(args) -> int:
    from mano_hand_tpu_torch.io.obj import export_obj_sequence
    from mano_hand_tpu_torch.models import core

    params = _load_params(args.asset, args.side,
                          args.device).astype(torch.float32)
    poses = _load_pose_sequence(args.poses, params)
    if str(args.out).endswith(".glb") and args.skinned:
        # Engine-ready skeletal export: joint hierarchy + LBS weights +
        # the clip as quaternion rotation tracks. Only the one rest-pose
        # forward runs: the skin carries the animation.
        from mano_hand_tpu_torch.io.gltf import export_glb_skinned

        with torch.no_grad():
            rest = core.forward(params)
        path = export_glb_skinned(
            rest.verts, params.faces, rest.joints, params.parents,
            params.lbs_weights, args.out, pose_frames=poses, fps=args.fps,
        )
        print(f"wrote {poses.shape[0]}-frame skinned GLB to {path}")
        return 0
    out = _forward_clip(params, poses)
    if str(args.out).endswith(".glb"):
        # One self-contained viewer-ready file: the clip as a morph-target
        # animation.
        from mano_hand_tpu_torch.io.gltf import export_glb

        path = export_glb(out.verts[0], params.faces, args.out,
                          morph_frames=out.verts, fps=args.fps)
        print(f"wrote {poses.shape[0]}-frame animated GLB to {path}")
        return 0
    paths = export_obj_sequence(out.verts, params.faces, args.out)
    print(f"wrote {len(paths)} frames to {args.out}/")
    return 0


def cmd_render(args) -> int:
    from mano_hand_tpu_torch import viz

    params = _load_params(args.asset, args.side,
                          args.device).astype(torch.float32)
    poses = _load_pose_sequence(args.poses, params)
    out = _forward_clip(params, poses)
    frames = viz.render_sequence(
        out.verts, params.faces, height=args.size, width=args.size,
    )
    dst = Path(args.out)
    if dst.suffix == ".avi":
        # The reference's animation demo output format.
        viz.write_avi(frames, dst, fps=args.fps)
        print(f"wrote {dst} ({len(frames)} frames)")
    elif dst.suffix == ".gif":
        viz.write_gif(frames, dst, fps=args.fps)
        print(f"wrote {dst} ({len(frames)} frames)")
    else:
        dst.mkdir(parents=True, exist_ok=True)
        for t, frame in enumerate(frames):
            viz.write_png(frame, dst / f"frame_{t:05d}.png")
        print(f"wrote {len(frames)} PNGs to {dst}/")
    return 0


def _load_init(path, want_trans=False):
    """Warm-start checkpoint -> (init dict, None) or (None, error).

    The dict holds 'pose'/'shape', plus 'trans' when the checkpoint has
    one and the new fit wants it (otherwise the stale estimate is dropped
    with a note: the solvers reject unknown init keys).
    """
    from mano_hand_tpu_torch.io.checkpoints import load_arrays

    ck = load_arrays(path)
    missing = {"pose", "shape"} - set(ck)
    if missing:
        return None, (f"--init checkpoint lacks {sorted(missing)} "
                      f"(has {sorted(ck)})")
    init = {"pose": ck["pose"], "shape": ck["shape"]}
    if "trans" in ck:
        if want_trans:
            init["trans"] = ck["trans"]
        else:
            print("note: --init has a trans estimate but --fit-trans "
                  "is off; ignoring it", file=sys.stderr)
    return init, None


def cmd_fit(args) -> int:
    from mano_hand_tpu_torch import fitting
    from mano_hand_tpu_torch.io.checkpoints import save_fit_result

    dev = args.device
    params = _load_params(args.asset, args.side, dev).astype(torch.float32)
    tgt_lower = str(args.targets).lower()
    if tgt_lower.endswith((".ply", ".obj")):
        if args.data_term in ("silhouette", "depth"):
            # A mesh/point cloud is not an image; without this the value
            # guard below would emit a nonsense error for vertex
            # coordinates.
            fmt = (".npy/.png" if args.data_term == "silhouette"
                   else ".npy")   # PNG cannot carry meters
            print(f"a .ply/.obj is geometry, not an image: use a {fmt} "
                  f"[H, W] image with --data-term {args.data_term}",
                  file=sys.stderr)
            return 2
        # Scanner/DCC output directly: the vertex cloud (any faces are
        # irrelevant to the ICP data terms, which resample anyway; for
        # --data-term verts an OBJ written by this package or the
        # reference is in vertex correspondence already).
        if tgt_lower.endswith(".obj"):
            from mano_hand_tpu_torch.io.obj import read_obj

            targets = read_obj(args.targets).verts
        else:
            from mano_hand_tpu_torch.io.ply import read_ply

            targets = read_ply(args.targets).verts
    elif str(args.targets).lower().endswith(".png"):
        if args.data_term != "silhouette":
            print("a .png target is a segmentation mask: use "
                  "--data-term silhouette", file=sys.stderr)
            return 2
        try:
            from PIL import Image
        except ImportError:
            print("reading .png masks needs Pillow; save the mask as a "
                  ".npy [H, W] float array in [0, 1] instead",
                  file=sys.stderr)
            return 2
        # Grayscale, normalized to [0, 1] — the range the soft-IoU loss
        # is defined on (the library rejects raw 0/255 by value).
        targets = (
            np.asarray(Image.open(args.targets).convert("L"), np.float32)
            / 255.0
        )
    else:
        targets = np.load(args.targets)  # [V|J, 3|2] or [B, V|J, 3|2]
        if args.data_term == "silhouette":
            targets = np.asarray(targets, np.float32)
            if targets.size and (targets.min() < 0 or targets.max() > 1):
                # Mirror the library's value guard with a CLI-shaped
                # error instead of a traceback.
                print("mask values must be in [0, 1] (got "
                      f"[{targets.min():g}, {targets.max():g}]); divide "
                      "a 0/255 mask by 255", file=sys.stderr)
                return 2
        elif args.data_term == "depth":
            targets = np.asarray(targets, np.float32)
            if targets.size and targets.ndim >= 2 and not (
                (targets > 0).any(axis=(-2, -1)).all()
            ):
                # Per image: one dropped-out frame in a batch would fit
                # to nothing and report its init as converged.
                print("depth target has image(s) with no valid "
                      "(positive) pixels — depth is view-space meters, "
                      "<= 0 or NaN = no reading", file=sys.stderr)
                return 2
    if args.data_term not in ("joints", "keypoints2d"):
        # Name the real conflict for BOTH keypoint flags here — sending
        # the user to --tips from the openpose check would ping-pong them
        # straight into this error.
        if args.tips:
            print("--tips only applies to --data-term joints/keypoints2d",
                  file=sys.stderr)
            return 2
        if args.keypoint_order != "mano":
            print("--keypoint-order only applies to --data-term "
                  "joints/keypoints2d", file=sys.stderr)
            return 2
    try:
        from mano_hand_tpu_torch.models.core import resolve_tip_ids

        tips = resolve_tip_ids(args.tips or None, params.n_verts)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    n_kp = params.n_joints + (len(tips) if tips else 0)
    if args.keypoint_order == "openpose" and n_kp != 21:
        print("--keypoint-order openpose is the 21-point convention; "
              "pass --tips smplx|manopth", file=sys.stderr)
        return 2
    kp_kw = {}
    if args.data_term in ("joints", "keypoints2d"):
        kp_kw = dict(tip_vertex_ids=tips, keypoint_order=args.keypoint_order)
    if args.data_term in ("silhouette", "depth"):
        # Masks/depth maps are [H, W] / [B, H, W] images, not
        # [rows, coords] arrays. A zero-size image has a constant loss —
        # zero gradients, and the INIT would be saved as a "successful"
        # fit (same class the point-term empty check keeps out).
        if targets.ndim not in (2, 3) or 0 in targets.shape:
            print(f"image targets must be non-empty [H, W] or [B, H, W] "
                  f"for --data-term {args.data_term}, got "
                  f"{targets.shape}", file=sys.stderr)
            return 2
    else:
        if args.data_term == "keypoints2d":
            want = (n_kp, 2)
        elif args.data_term == "joints":
            want = (n_kp, 3)
        elif args.data_term in ("points", "point_to_plane"):
            want = (None, 3)  # any number of scan points, 3D
        else:
            want = (params.n_verts, 3)
        rows_ok = (
            targets.ndim >= 2
            and (targets.shape[-2] == want[0] if want[0] is not None
                 else targets.shape[-2] > 0)  # empty scan would fit to NaN
        )
        if (targets.ndim not in (2, 3) or targets.shape[-1] != want[1]
                or not rows_ok):
            rows = "N" if want[0] is None else str(want[0])
            print(
                f"targets must be [{rows}, {want[1]}] or "
                f"[B, {rows}, {want[1]}] for --data-term {args.data_term}, "
                f"got {targets.shape}",
                file=sys.stderr,
            )
            return 2
    if args.heatmap and (args.data_term != "verts" or targets.ndim != 2):
        # The heatmap colors per-vertex errors against the target, which
        # needs known correspondence and ONE problem.
        print("--heatmap requires --data-term verts with a single "
              "[V, 3] target", file=sys.stderr)
        return 2
    if not 0.0 <= args.trim < 1.0:
        print(f"--trim must be in [0, 1), got {args.trim}", file=sys.stderr)
        return 2
    if args.trim and args.data_term not in ("points", "point_to_plane"):
        # Checked BEFORE any solver resolution: naming only the solver
        # here would ping-pong the user into the opposite error.
        print("--trim only applies to --data-term points/point_to_plane",
              file=sys.stderr)
        return 2
    if (args.robust_weights != "none"
            and args.data_term not in ("points", "point_to_plane")):
        print("--robust-weights only applies to --data-term "
              "points/point_to_plane", file=sys.stderr)
        return 2
    # Pose spaces LM cannot optimize need the Adam solver — ONE
    # definition, shared with the explicit-LM guard below, so a future
    # pose space fails safe instead of silently routing to LM. LM
    # handles "aa" (its native parameterization) and "pca" (GN in the
    # truncated space, fit_lm pose_space="pca"); an UNSET solver still
    # resolves pca to adam (priors/6d interplay live there) — pca-LM is
    # an explicit `--solver lm` choice.
    needs_adam = args.pose_space not in (None, "aa", "pca")
    explicit_pca_lm = args.pose_space == "pca" and args.solver == "lm"
    if args.solver is None:
        if needs_adam or args.pose_space == "pca":
            args.solver = "adam"
        else:
            args.solver = ("lm" if args.data_term
                           in ("verts", "point_to_plane") else "adam")
    steps = (
        args.steps if args.steps is not None
        else (25 if args.solver == "lm" else 200)
    )
    if args.conf is not None and args.data_term != "keypoints2d":
        # Mirror the library-level guard (solvers reject conf/camera
        # outside keypoints2d) instead of silently dropping the file.
        print("--conf only applies to --data-term keypoints2d",
              file=sys.stderr)
        return 2
    if args.data_term not in ("silhouette", "depth"):
        # Refuse rather than silently drop (the --tips/--trim pattern):
        # these flags change the fit ONLY through the rasterized paths.
        for flag, val in (("--camera-scale", args.camera_scale),
                          ("--camera-rot", args.camera_rot),
                          ("--sil-sigma", args.sil_sigma)):
            if val is not None:
                print(f"{flag} only applies to --data-term "
                      "silhouette/depth", file=sys.stderr)
                return 2
    else:
        if args.data_term == "depth" and (
            args.camera_scale is not None or args.camera_rot
        ):
            # Weak perspective has no meaningful depth axis — a depth
            # image only makes sense under a real (pinhole) projection.
            print("--camera-scale/--camera-rot are the weak-perspective "
                  "silhouette flags; --data-term depth uses the default "
                  "pinhole camera or --camera-k", file=sys.stderr)
            return 2
        # Degenerate-value guards (same class as the empty-mask check):
        # scale 0 projects everything to one point (constant image, zero
        # gradients, the init saved as a "fit"); sigma 0 divides by zero
        # in the rasterizer and negative sigma inverts inside/outside.
        if args.camera_scale is not None and args.camera_scale <= 0:
            print(f"--camera-scale must be > 0, got {args.camera_scale}",
                  file=sys.stderr)
            return 2
        if args.sil_sigma is not None and args.sil_sigma <= 0:
            print(f"--sil-sigma must be > 0, got {args.sil_sigma}",
                  file=sys.stderr)
            return 2
    intr_cam = None
    if args.camera_k:
        # Dataset calibration: K entries + image size. Takes precedence
        # over the synthetic-camera flags; keypoint targets are then
        # PIXEL coordinates (the annotation convention) and are
        # converted once via pixels_to_ndc. Validated BEFORE solver
        # resolution so e.g. a verts fit (LM default) still refuses it.
        if args.data_term not in ("keypoints2d", "silhouette", "depth"):
            print("--camera-k only applies to --data-term "
                  "keypoints2d/silhouette/depth", file=sys.stderr)
            return 2
        try:
            fx, fy, cx, cy = (float(x) for x in args.camera_k.split(","))
            w_str, _, h_str = (args.camera_size or "").partition("x")
            cam_w, cam_h = int(w_str), int(h_str)
        except ValueError as e:
            print("--camera-k must be 'fx,fy,cx,cy' with "
                  f"--camera-size 'WxH': {e}", file=sys.stderr)
            return 2
        from mano_hand_tpu_torch.viz.camera import from_intrinsics

        try:
            intr_cam = from_intrinsics(
                [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], cam_w, cam_h,
                device=dev,
            )
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
    elif args.camera_size is not None:
        print("--camera-size only applies with --camera-k",
              file=sys.stderr)
        return 2
    if args.solver == "lm" and (args.pose_prior != "l2"
                                or args.pose_prior_weight is not None):
        # Either prior flag under LM is a contradiction, not a preference
        # — silently dropping a requested regularization weight would
        # return a different fit than the user asked for.
        print("--pose-prior/--pose-prior-weight require --solver adam "
              "(LM regularizes via its Tikhonov shape rows)",
              file=sys.stderr)
        return 2
    if args.solver == "lm" and args.joint_limits is not None:
        print("--joint-limits requires --solver adam (the hinge prior "
              "is a first-order energy term)", file=sys.stderr)
        return 2
    if args.joint_limit_weight is not None and args.joint_limits is None:
        print("--joint-limit-weight without --joint-limits does nothing; "
              "pass the bounds file", file=sys.stderr)
        return 2
    if args.restarts:
        if args.init:
            print("--restarts owns the initialization (zero + Kabsch + "
                  "sampled seeds); drop --init", file=sys.stderr)
            return 2
        if args.restarts < 1:
            print(f"--restarts must be >= 1, got {args.restarts}",
                  file=sys.stderr)
            return 2
    if args.solver == "lm":
        if args.lr is not None:
            print("note: --lr only applies to --solver adam; ignored",
                  file=sys.stderr)
        if args.data_term in ("keypoints2d", "silhouette", "depth"):
            print(f"--data-term {args.data_term} requires --solver adam",
                  file=sys.stderr)
            return 2
        if args.robust != "none":
            # Materially changes the result — refuse rather than note:
            # the GN residual has no robustifier.
            print("--robust requires --solver adam", file=sys.stderr)
            return 2
        lm_kw = {}
        if args.data_term in ("joints", "points", "point_to_plane"):
            # LM's Tikhonov rows stand in for the Adam path's shape prior
            # (16 joints — or a partial scan — underdetermine shape).
            lm_kw = dict(
                data_term=args.data_term,
                shape_weight=(0.1 if args.shape_prior is None
                              else args.shape_prior),
            )
        elif args.shape_prior is not None:
            print("note: --shape-prior only applies to --solver adam or "
                  "--data-term joints/points/point_to_plane; ignored",
                  file=sys.stderr)
        if args.fit_trans:
            lm_kw["fit_trans"] = True
        if args.init:
            init, err = _load_init(args.init, want_trans=args.fit_trans)
            if err:
                print(err, file=sys.stderr)
                return 2
            lm_kw["init"] = init
        if args.trim:
            lm_kw["trim_fraction"] = args.trim
        if args.robust_weights != "none":
            lm_kw["robust_weights"] = args.robust_weights
        if needs_adam:
            # Only reachable with an EXPLICIT --solver lm (an unset solver
            # resolves to adam for these spaces): a contradiction, not a
            # preference — refuse rather than silently drop it. 'aa' is
            # LM's native parameterization and 'pca' its GN-in-the-
            # truncated-space mode; both pass through.
            print(f"--pose-space {args.pose_space} requires --solver adam "
                  "(LM optimizes axis-angle or PCA coefficients)",
                  file=sys.stderr)
            return 2
        if explicit_pca_lm:
            if args.restarts:
                # fit_restarts samples axis-angle inits (restarts.py
                # rejects pca): name the conflict here with the fix.
                print("--restarts with --solver lm samples axis-angle "
                      "inits; drop --pose-space pca or drop --restarts",
                      file=sys.stderr)
                return 2
            if lm_kw.get("init"):
                # JSON inits ship pose/shape arrays; the pca
                # parameterization expects {global_rot, pca, shape}.
                ik = set(lm_kw["init"])
                if not ik <= {"global_rot", "pca", "shape"}:
                    print("--init for --pose-space pca LM must hold "
                          "global_rot/pca/shape keys, got "
                          f"{sorted(ik)}", file=sys.stderr)
                    return 2
            lm_kw["pose_space"] = "pca"  # library-default n_pca (full)
        if args.restarts:
            try:
                res, _losses = fitting.fit_restarts(
                    params, targets, n_restarts=args.restarts,
                    solver="lm", n_steps=steps, **lm_kw, **kp_kw)
            except ValueError as e:   # e.g. batched targets
                print(f"--restarts: {e}", file=sys.stderr)
                return 2
        else:
            res = fitting.fit_lm(params, targets, n_steps=steps, **lm_kw,
                                 **kp_kw)
    else:
        if args.trim:
            print("--trim requires --solver lm (the Adam chamfer path "
                  "uses --robust huber instead)", file=sys.stderr)
            return 2
        if args.robust_weights != "none":
            print("--robust-weights requires --solver lm (the Adam "
                  "chamfer path uses --robust huber instead)",
                  file=sys.stderr)
            return 2
        if args.data_term == "point_to_plane":
            # The Adam path has no normal-distance residual; the GN
            # solver owns this polish stage. Name the FULL conflict when
            # a pose space forced the adam resolution — "use --solver lm"
            # alone would send the user into the opposite error.
            if needs_adam:
                print("--data-term point_to_plane is LM-only and LM "
                      "optimizes axis-angle or PCA coefficients: it "
                      f"cannot combine with --pose-space {args.pose_space}"
                      "; drop the pose space or use --data-term points",
                      file=sys.stderr)
            elif args.pose_space == "pca":
                # Unset solver resolved pca->adam; the combination IS
                # available, but only as an explicit LM choice.
                print("--data-term point_to_plane requires --solver lm; "
                      "pass --solver lm explicitly to combine it with "
                      "--pose-space pca", file=sys.stderr)
            else:
                print("--data-term point_to_plane requires --solver lm",
                      file=sys.stderr)
            return 2
        # Shape is weakly observable from 16 joints; regularize it
        # (unless the user set an explicit weight). A mask observes shape
        # only through the outline area — hold it near zero by default.
        shape_prior = (
            args.shape_prior if args.shape_prior is not None
            else (0.0 if args.data_term == "verts"
                  else 1.0 if args.data_term in ("silhouette", "depth")
                  else 1e-3)
        )
        kp2d = {}
        default_lr = 0.05
        if args.data_term == "silhouette":
            if args.robust != "none":
                print("--robust does not apply to --data-term silhouette "
                      "(the IoU is already bounded per image)",
                      file=sys.stderr)
                return 2
            if args.camera_eye is not None or args.focal is not None:
                # Refuse rather than silently drop (same contract as the
                # depth branch): these pinhole flags LOOK applicable but
                # the silhouette camera is weak-perspective
                # (--camera-scale/--camera-rot) or --camera-k only.
                print("--camera-eye/--focal apply to keypoints2d; "
                      "--data-term silhouette uses a weak-perspective "
                      "camera (--camera-scale/--camera-rot) or --camera-k",
                      file=sys.stderr)
                return 2
            if intr_cam is not None:
                if args.camera_scale is not None or args.camera_rot:
                    print("--camera-scale/--camera-rot conflict with "
                          "--camera-k (the calibration IS the camera)",
                          file=sys.stderr)
                    return 2
                if targets.shape[-2:] != (intr_cam.height,
                                          intr_cam.width):
                    # Both sides HxW so a transposed mask reads as the
                    # mismatch it is.
                    print(f"mask resolution {targets.shape[-2]}x"
                          f"{targets.shape[-1]} (HxW) must match "
                          f"--camera-size {intr_cam.height}x"
                          f"{intr_cam.width} (HxW)",
                          file=sys.stderr)
                    return 2
                sil_camera = intr_cam
            else:
                from mano_hand_tpu_torch.viz.camera import (
                    WeakPerspectiveCamera, view_rotation,
                )

                try:
                    rot = [float(x)
                           for x in (args.camera_rot or "0,0,0").split(",")]
                    if len(rot) != 3:
                        raise ValueError(
                            f"need 3 components, got {len(rot)}"
                        )
                except ValueError as e:
                    print(f"--camera-rot must be 'x,y,z' axis-angle: {e}",
                          file=sys.stderr)
                    return 2
                # Weak perspective by design: under a pinhole camera a
                # mask fit inflates the hand toward the lens (measured,
                # see docs/api.md); the scaled-orthographic model removes
                # that axis. (A REAL calibration via --camera-k is the
                # exception: its depth is meaningful, trust it.)
                sil_camera = WeakPerspectiveCamera(
                    rot=view_rotation(rot, device=dev),
                    scale=(3.0 if args.camera_scale is None
                           else args.camera_scale),
                )
            # Translation is the one thing an outline observes strongly
            # — always fit it.
            default_lr = 0.01
            kp2d = dict(
                camera=sil_camera,
                fit_trans=True,
                sil_sigma=(1.0 if args.sil_sigma is None
                           else args.sil_sigma),
            )
        if args.data_term == "depth":
            # Depth needs a REAL projection (weak perspective has no
            # depth axis): the dataset calibration when given, else the
            # default pinhole framing. One depth image observes full 3D
            # translation — always fit it.
            if args.camera_eye is not None or args.focal is not None:
                # Refuse rather than silently drop: these pinhole flags
                # LOOK applicable here but the depth camera is the
                # default framing or --camera-k only.
                print("--camera-eye/--focal apply to keypoints2d; "
                      "--data-term depth uses the default pinhole "
                      "camera or --camera-k", file=sys.stderr)
                return 2
            if intr_cam is not None:
                depth_camera = intr_cam
                if targets.shape[-2:] != (intr_cam.height,
                                          intr_cam.width):
                    print(f"depth resolution {targets.shape[-2]}x"
                          f"{targets.shape[-1]} (HxW) must match "
                          f"--camera-size {intr_cam.height}x"
                          f"{intr_cam.width} (HxW)", file=sys.stderr)
                    return 2
            else:
                from mano_hand_tpu_torch.viz.camera import (
                    default_hand_camera,
                )

                depth_camera = default_hand_camera(device=dev)
            default_lr = 0.01
            kp2d = dict(
                camera=depth_camera,
                fit_trans=True,
                sil_sigma=(1.0 if args.sil_sigma is None
                           else args.sil_sigma),
            )
        if args.data_term == "keypoints2d":
            conf = None
            if args.conf:
                conf = np.load(args.conf).astype(np.float32)
                want_conf = targets.shape[:-1]
                if conf.shape not in (want_conf, want_conf[-1:]):
                    print(f"--conf must be {list(want_conf)} (or "
                          f"[{want_conf[-1]}] shared) to match targets "
                          f"{targets.shape}, got {conf.shape}",
                          file=sys.stderr)
                    return 2
            if intr_cam is not None:
                if args.camera_eye is not None or args.focal is not None:
                    # Refuse rather than silently drop (the file-wide
                    # pattern): the calibration IS the camera.
                    print("--camera-eye/--focal conflict with --camera-k",
                          file=sys.stderr)
                    return 2
                # Dataset convention: the .npy targets are PIXEL
                # coordinates on the calibrated image; convert once.
                targets = as_numpy(intr_cam.pixels_to_ndc(
                    torch.from_numpy(targets.astype(np.float32))
                ))
                kp_camera = intr_cam
            else:
                from mano_hand_tpu_torch.viz.camera import look_at

                try:
                    eye = [float(x) for x in
                           (args.camera_eye or "0,0,-0.75").split(",")]
                    if len(eye) != 3:
                        raise ValueError(
                            f"need 3 components, got {len(eye)}"
                        )
                except ValueError as e:
                    print(f"--camera-eye must be 'x,y,z': {e}",
                          file=sys.stderr)
                    return 2
                kp_camera = look_at(
                    eye=eye,
                    focal=2.2 if args.focal is None else args.focal,
                    device=dev,
                )
            # 2D data is depth-blind: fit a global translation, use the
            # better-conditioned PCA pose space, a mild pose prior, and a
            # gentler step (the defaults the library-level tests validate).
            default_lr = 0.02
            kp2d = dict(
                camera=kp_camera,
                target_conf=conf,
                fit_trans=True,
                n_pca=15,
            )
        # One decision point for the effective pose space: the user's
        # explicit choice, else pca for depth-blind 2D keypoints, else aa
        # (incl. silhouette — the mask defaults are validated in aa).
        pose_space = args.pose_space or (
            "pca" if args.data_term == "keypoints2d" else "aa"
        )
        if args.pose_prior == "mahalanobis" and pose_space == "6d":
            print("--pose-prior mahalanobis needs axis-angle statistics: "
                  "use --pose-space aa or pca", file=sys.stderr)
            return 2
        joint_limits = None
        if args.joint_limits is not None:
            if pose_space == "6d":
                print("--joint-limits are axis-angle bounds: use "
                      "--pose-space aa or pca", file=sys.stderr)
                return 2
            try:
                with np.load(args.joint_limits) as lim:
                    if "lo" not in lim or "hi" not in lim:
                        raise ValueError(
                            f"needs keys lo/hi, has {sorted(lim.files)}")
                    lo, hi = lim["lo"], lim["hi"]
            except Exception as e:  # unreadable/malformed file
                print(f"--joint-limits {args.joint_limits}: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
                return 2
            n_dof = (params.n_joints - 1) * 3
            if lo.shape != (n_dof,) or hi.shape != (n_dof,):
                print(f"--joint-limits lo/hi must be [{n_dof}]; got "
                      f"{lo.shape}/{hi.shape}", file=sys.stderr)
                return 2
            if not (np.asarray(lo) <= np.asarray(hi)).all():
                print("--joint-limits has lo > hi entries — swapped "
                      "bounds would wall off the whole axis",
                      file=sys.stderr)
                return 2
            joint_limits = (lo, hi)
        # Default pose-prior weight: the 2D term is depth-blind and always
        # needs one; elsewhere the data-driven prior defaults on gently
        # when selected, and the isotropic prior stays off.
        pose_prior_weight = args.pose_prior_weight
        if pose_prior_weight is None:
            if args.data_term == "keypoints2d":
                pose_prior_weight = 1e-4
            elif args.data_term in ("silhouette", "depth"):
                # A single image cannot pin articulation: hold the pose
                # hard and let translation do the observable work (the
                # weight the image-recovery tests validate). Lower it
                # when combining with more views or keypoints.
                pose_prior_weight = 1.0
            elif args.pose_prior == "mahalanobis":
                pose_prior_weight = 1e-3
            else:
                pose_prior_weight = 0.0
        init = None
        if args.init:
            if pose_space != "aa":
                # fit() warm-starts in the ACTIVE parameterization, and
                # checkpoints store axis-angle pose.
                print("--init requires the axis-angle pose space "
                      f"(active: {pose_space})", file=sys.stderr)
                return 2
            init, err = _load_init(
                args.init,
                want_trans=args.fit_trans or kp2d.get("fit_trans", False))
            if err:
                print(err, file=sys.stderr)
                return 2
        adam_kw = dict(
            n_steps=steps,
            lr=default_lr if args.lr is None else args.lr,
            data_term=args.data_term,
            shape_prior_weight=shape_prior,
            pose_space=pose_space,
            pose_prior=args.pose_prior,
            pose_prior_weight=pose_prior_weight,
            joint_limits=joint_limits,
            joint_limit_weight=(1.0 if args.joint_limit_weight is None
                                else args.joint_limit_weight),
            robust=args.robust, robust_scale=args.robust_scale,
            **kp2d,
            **kp_kw,
        )
        # The 2D/image paths force translation on via their own dicts
        # (kp2d/silhouette/depth); setdefault keeps that while --fit-trans
        # turns it on for the 3D terms.
        adam_kw.setdefault("fit_trans", args.fit_trans)
        if args.restarts:
            if pose_space != "aa":
                # fit_restarts samples axis-angle seeds by design.
                print(f"--restarts requires the axis-angle pose space "
                      f"(active: {pose_space})", file=sys.stderr)
                return 2
            try:
                res, _losses = fitting.fit_restarts(
                    params, targets, n_restarts=args.restarts,
                    solver="adam", **adam_kw)
            except ValueError as e:   # e.g. batched targets
                print(f"--restarts: {e}", file=sys.stderr)
                return 2
        else:
            res = fitting.fit(params, targets, init=init, **adam_kw)
    path = save_fit_result(res, args.out)
    final = float(np.max(as_numpy(res.final_loss)))
    print(f"fit ({args.solver}, {steps} steps) -> {path} "
          f"(worst final loss {final:.3e})")
    if args.heatmap:
        from mano_hand_tpu_torch.models import core
        from mano_hand_tpu_torch.viz import error_colormap, render_mesh
        from mano_hand_tpu_torch.viz.png import write_png

        with torch.no_grad():
            fitted = core.forward(params, res.pose, res.shape).verts
            if getattr(res, "trans", None) is not None:
                fitted = fitted + res.trans
            errs = torch.linalg.norm(
                fitted - torch.as_tensor(np.asarray(targets, np.float32),
                                         device=fitted.device), dim=-1
            )
            colors = error_colormap(errs)
            if str(args.heatmap).lower().endswith(".glb"):
                # A 3D-inspectable heatmap: the fitted mesh with COLOR_0
                # vertex colors, orbitable in any glTF viewer.
                from mano_hand_tpu_torch.io.gltf import export_glb

                export_glb(fitted, params.faces, args.heatmap,
                           vertex_colors=colors)
            else:
                img = render_mesh(fitted, params.faces, vertex_colors=colors)
                write_png(img, args.heatmap)
        print(f"error heatmap (max {float(errs.max()) * 1e3:.2f} mm) -> "
              f"{args.heatmap}")
    return 0


def cmd_info(args) -> int:
    params = _load_params(args.asset, args.side, args.device)
    info = {
        "side": params.side,
        "n_verts": params.n_verts,
        "n_joints": params.n_joints,
        "n_faces": int(params.faces.shape[0]),
        "n_shape": params.n_shape,
        "parents": list(params.parents),
        "dtype": str(as_numpy(params.v_template).dtype),
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_verify(args) -> int:
    # The truth anchor for user-supplied official pickles: structural
    # gates, numeric invariants and canonical digests (assets/verify.py).
    from mano_hand_tpu_torch.assets.verify import (
        format_report, report_json, verify_asset,
    )

    try:
        report = verify_asset(args.asset, side=args.side,
                              golden=args.golden, device=args.device)
    except Exception as e:  # noqa: BLE001 — decode failures ARE the verdict
        print(f"verify: {args.asset} failed to decode as a MANO asset: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(report_json(report, expect=args.expect))
        ok = report.gates_ok and (
            args.expect is None
            or report.digests["combined"] == args.expect)
        return 0 if ok else 1
    text, rc = format_report(report, args.asset, expect=args.expect)
    print(text)
    return rc


def cmd_export_aot(args) -> int:
    """Serialize the forward as a self-contained serving artifact."""
    import os

    from mano_hand_tpu_torch.io.export_aot import save_forward

    params = _load_params(args.asset, args.side, "cpu").astype(torch.float32)
    path = save_forward(
        params, args.out,
        batch=args.batch if args.batch else "b",
        tip_vertex_ids=args.tips or None,
        keypoint_order=args.keypoint_order,
        platforms=tuple(args.platforms.split(",")),
    )
    print(f"exported AOT forward -> {path} ({os.path.getsize(path)} bytes; "
          "params baked in; consumer needs only torch + "
          "mano_hand_tpu_torch.io.export_aot.load_forward)")
    return 0


def cmd_trace_report(args) -> int:
    """One merged host+device timeline report over a ``torch.profiler``
    capture (``utils.profiling.torch_trace``) and/or an engine span export
    (``obs.write_trace_dir``): ``obs/trace_report.py``, with JAX's flags,
    output and exit codes. It reads files only: ``--device`` is unused."""
    from mano_hand_tpu_torch.obs import trace_report

    argv = [str(args.path), "--top", str(args.top)]
    if args.json:
        argv.append("--json")
    if args.all_tracks:
        argv.append("--all-tracks")
    return trace_report.run(argv)


def _no_card(args, cmd: str) -> bool:
    """True (after saying so) when ``cmd`` would run on a card this
    machine lacks: ``serve``/``serve-bench`` never serve from the CPU on
    their own — ``--device cpu`` asks for it."""
    if args.device == "cuda" and not torch.cuda.is_available():
        print(f"{cmd}: CUDA is not available on this machine; the port "
              "serves on the GPU by default and never falls back to the "
              "CPU on its own — pass --device cpu to serve there",
              file=sys.stderr)
        return True
    return False


def cmd_serve_bench(args) -> int:
    """Drive the serving engine with a synthetic ragged request stream and
    print ONE JSON line of serving metrics (engine vs direct throughput,
    steady builds, padding waste, per-bucket latency). The protocol lives
    in ``serving.measure.serve_bench_run``. ``--chaos`` injects a
    deterministic fault plan under supervised dispatch, or runs the full
    recovery drill with ``--chaos drill``; ``--subjects N`` switches to
    the mixed-subject coalescing protocol (``coalesce_bench_run``);
    ``--overload`` runs the overload drill; ``--cold-start`` the restart
    drill against a persistent ``--aot-dir``; ``--streams N`` the
    streaming-session drill. ``--trace DIR`` spans every request and
    exports the timeline and final flight record into DIR for
    ``trace-report``; ``--metrics DIR`` persists the engine's final
    registry scrape for ``status --metrics-dir`` — stdout stays EXACTLY
    one JSON line (progress and incidents ride stderr / the trace dir).
    JAX's flags, guards and exit codes; the line's ``backend`` is the
    device type."""
    import os

    from mano_hand_tpu_torch.obs import log as obs_log
    from mano_hand_tpu_torch.serving.measure import serve_bench_run

    # Progress rides the leveled stderr logger, pinned to "info" here;
    # stdout remains the one-JSON-line artifact channel.
    log = obs_log.get_logger("serve-bench", level="info").info

    if args.chaos != "drill":
        # The drill fixes its own protocol sizes; these knobs shape the
        # serve_bench_run stream only.
        if args.requests < 1:
            print(f"--requests must be >= 1, got {args.requests}",
                  file=sys.stderr)
            return 2
        if args.min_rows < 1 or args.max_rows < args.min_rows:
            print(f"need 1 <= --min-rows <= --max-rows, got "
                  f"({args.min_rows}, {args.max_rows})", file=sys.stderr)
            return 2
        if args.max_rows > args.max_bucket:
            print(f"--max-rows {args.max_rows} exceeds --max-bucket "
                  f"{args.max_bucket}", file=sys.stderr)
            return 2
    if _no_card(args, "serve-bench"):
        return 2
    dev = args.device
    params = _load_params(args.asset, args.side, "cpu").astype(torch.float32)

    # Deadline watchdog: a wedged device call cannot be interrupted from
    # Python, so a daemon THREAD prints the null line and hard-exits at
    # the deadline. Armed before any card call (the engines' first touch
    # of the card is inside the protocols below); the auto default
    # (--emit-by unset) arms at 900 s and is disarmed on a --device cpu
    # run, which has no card to wedge.
    from mano_hand_tpu_torch.runtime.supervise import Watchdog

    tracer = None
    if args.trace:
        from mano_hand_tpu_torch.obs import Tracer

        tracer = Tracer()

    metrics_reg = None
    if args.metrics:
        # The drill protocols fix their own engines internally: refuse
        # rather than silently export an empty registry.
        if (args.overload or args.cold_start or args.subjects > 0
                or args.streams > 0 or args.chaos == "drill"):
            print("--metrics composes only with the default protocol "
                  "(optionally under a --chaos plan); the drill "
                  "protocols (--overload/--cold-start/--subjects/"
                  "--streams/--chaos drill) fix their own engines and "
                  "export nothing into a caller registry",
                  file=sys.stderr)
            return 2
        from mano_hand_tpu_torch.obs import MetricsRegistry

        metrics_reg = MetricsRegistry()

    emit_by = 900.0 if args.emit_by < 0 else args.emit_by

    def _hard_exit(cause: str) -> None:
        # The one-JSON-line artifact prints FIRST; the trace dump runs on
        # a disposable thread with a bounded join, and os._exit lands
        # regardless.
        print(json.dumps({
            "engine_evals_per_sec": None,
            "error": f"serve-bench {cause} — hung device call",
        }), flush=True)
        if tracer is not None:
            def dump():
                try:
                    from mano_hand_tpu_torch.obs import write_trace_dir

                    write_trace_dir(tracer, args.trace,
                                    reason="watchdog_kill")
                except Exception:  # noqa: BLE001 — best-effort dump
                    pass

            import threading

            t = threading.Thread(target=dump, name="trace-dump",
                                 daemon=True)
            t.start()
            t.join(10.0)
        os._exit(3)

    wd = Watchdog(_hard_exit, deadline_s=emit_by or None,
                  name="serve-bench-watchdog", tracer=tracer).start()
    if args.emit_by < 0 and dev == "cpu":
        wd.disarm()  # auto mode: no card to guard against on cpu

    def export_trace(out: dict) -> None:
        """Drop the timeline + final flight record into --trace DIR; an
        unwritable dir is recorded in the artifact, never a lost run."""
        if tracer is None:
            return
        try:
            from mano_hand_tpu_torch.obs import write_trace_dir

            out["trace_export"] = write_trace_dir(tracer, args.trace,
                                                  reason="run_complete")
        except OSError as e:
            out["trace_export"] = {
                "error": f"{type(e).__name__}: {e} (trace dir "
                         f"{args.trace!r} unwritable; the run's "
                         "metrics above are unaffected)"}

    def finish(out: dict) -> int:
        out["backend"] = dev
        if args.chaos and args.chaos != "drill":
            out["chaos"] = args.chaos
        export_trace(out)
        print(json.dumps(out))
        return 0

    if args.cold_start:
        if (args.chaos or args.subjects > 0 or args.overload
                or args.streams > 0 or args.deadline_s is not None):
            print("--cold-start fixes its own protocol and does not "
                  "compose with --chaos, --subjects, --overload, "
                  "--streams, or --deadline-s", file=sys.stderr)
            return 2
        if not args.aot_dir:
            print("--cold-start requires --aot-dir (the executable "
                  "lattice and SubjectTable checkpoint live there; "
                  "without it there is nothing for a restart to "
                  "restore from)", file=sys.stderr)
            return 2
        from mano_hand_tpu_torch.serving.measure import cold_start_drill_run

        return finish(cold_start_drill_run(
            params, aot_dir=args.aot_dir, seed=args.seed, tracer=tracer,
            device=dev, log=log))

    if args.streams > 0:
        if (args.chaos or args.subjects > 0 or args.overload
                or args.cold_start or args.aot_dir
                or args.deadline_s is not None):
            print("--streams fixes its own protocol and does not "
                  "compose with --chaos, --subjects, --overload, "
                  "--cold-start, --aot-dir, or --deadline-s",
                  file=sys.stderr)
            return 2
        from mano_hand_tpu_torch.serving.measure import stream_drill_run

        return finish(stream_drill_run(
            params, streams=args.streams, seed=args.seed, tracer=tracer,
            device=dev, log=log))

    if args.overload:
        if (args.chaos or args.subjects > 0 or args.aot_dir
                or args.deadline_s is not None):
            print("--overload fixes its own protocol and does not "
                  "compose with --chaos, --subjects, --aot-dir, or "
                  "--deadline-s", file=sys.stderr)
            return 2
        from mano_hand_tpu_torch.serving.measure import overload_drill_run

        return finish(overload_drill_run(
            params, saturation=args.overload_saturation, seed=args.seed,
            tracer=tracer, device=dev, log=log))

    if args.chaos == "drill":
        if args.subjects > 0:
            print("--subjects does not compose with --chaos drill (the "
                  "drill fixes its own protocol, which already drives "
                  "mixed-subject pose-only streams); use --subjects "
                  "with a custom --chaos plan instead", file=sys.stderr)
            return 2
        from mano_hand_tpu_torch.serving.measure import recovery_drill_run

        # The drill fixes its own protocol sizes; only the deadline is
        # tunable.
        kw = ({} if args.deadline_s is None
              else {"deadline_s": args.deadline_s})
        return finish(recovery_drill_run(
            params, max_bucket=8, seed=args.seed, tracer=tracer,
            device=dev, log=log, **kw))
    policy = None
    if args.chaos:
        # A custom fault schedule under supervised dispatch; the breaker's
        # probe always answers True (the fault is simulated). The CPU
        # tier serves a CPU engine only.
        from mano_hand_tpu_torch.runtime import (
            ChaosPlan, CircuitBreaker, DispatchPolicy,
        )

        try:
            plan = ChaosPlan(args.chaos)
        except ValueError as e:
            print(f"--chaos {args.chaos!r}: {e}", file=sys.stderr)
            return 2
        policy = DispatchPolicy(
            deadline_s=30.0 if args.deadline_s is None else args.deadline_s,
            retries=2,
            breaker=CircuitBreaker(
                failure_threshold=3, probe=lambda: True,
                probe_interval_s=1.0, respect_priority_claim=False),
            chaos=plan, cpu_fallback=dev == "cpu",
        )
    if args.subjects > 0:
        if args.aot_dir:
            print("--aot-dir does not apply to --subjects (the gathered "
                  "programs have no AOT tier; table and index are "
                  "runtime arguments)", file=sys.stderr)
            return 2
        from mano_hand_tpu_torch.serving.measure import coalesce_bench_run

        return finish(coalesce_bench_run(
            params, subjects=args.subjects, requests=args.requests,
            min_rows=args.min_rows, max_rows=args.max_rows,
            max_bucket=args.max_bucket,
            max_delay_s=args.max_delay_ms * 1e-3, seed=args.seed,
            policy=policy, tracer=tracer, device=dev, log=log))
    out = serve_bench_run(
        params, requests=args.requests, min_rows=args.min_rows,
        max_rows=args.max_rows, max_bucket=args.max_bucket,
        max_delay_s=args.max_delay_ms * 1e-3,
        aot_dir=args.aot_dir or None, seed=args.seed, policy=policy,
        tracer=tracer, metrics=metrics_reg, device=dev)
    if metrics_reg is not None:
        # The final scrape as metrics.json + Prometheus text; an
        # unwritable dir is recorded in the artifact.
        try:
            from mano_hand_tpu_torch.obs.metrics import export_metrics_dir

            out["metrics_export"] = export_metrics_dir(
                metrics_reg.snapshot(), args.metrics)
        except OSError as e:
            out["metrics_export"] = {
                "error": f"{type(e).__name__}: {e} (metrics dir "
                         f"{args.metrics!r} unwritable; the run's "
                         "metrics above are unaffected)"}
    return finish(out)


def _control_from_prometheus(text: str) -> dict:
    """A worker's control block from its /metrics text: the
    ``load_control_*`` gauges (attached, running, crashed, version and the
    actuated values, Retry-After by tier) and the ``control_*`` counters
    (ticks, actuations, reverts). Empty when the text has none (a proxy)."""
    out: dict = {}
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, _, value = line.rpartition(" ")
        for prefix in ("mano_load_control_", "mano_serving_control_"):
            if not name.startswith(prefix):
                continue
            key, _, labels = name[len(prefix):].partition("{")
            v = float(value)
            if key in ("attached", "running", "crashed"):
                out[key] = v != 0.0
            elif labels:                   # retry_after_s{tier="1"}
                out.setdefault(key, {})[labels.split('"')[1]] = int(v)
            else:
                out[key] = v if key == "coalesce_base_s" else int(v)
    return out


def cmd_serve(args) -> int:
    """``serve`` — the network edge: one worker process exposing a
    ``ServingEngine`` over the edge wire protocol (``edge/server.py``):
    ``POST /v1/forward`` (+ ``/v1/specialize``) with QoS headers, the
    stream upgrade, 429 + Retry-After backpressure, ``/metrics``
    (Prometheus text) and ``/healthz``, flight-record-bearing 5xx bodies,
    and a graceful drain on SIGTERM/SIGINT through the engine's
    ``stop(timeout_s=)`` sweep.

    ``--device-lock auto`` takes the SHARED device lock
    (``utils.devicelock.DeviceLock("server")``) on the card — N workers
    coexist, an exclusive benchmark's lock or priority claim makes a new
    worker stand down with rc 2 — and no lock with ``--device cpu``.

    stdout carries exactly two JSON lines: the ready line at bind time
    (host/port/pid) and the drain report at exit; logs go to stderr.
    """
    import contextlib
    import os
    import signal
    import threading

    from mano_hand_tpu_torch.edge import EdgeServer
    from mano_hand_tpu_torch.obs import Tracer
    from mano_hand_tpu_torch.obs.metrics import engine_registry
    from mano_hand_tpu_torch.obs.recorder import FlightRecorder
    from mano_hand_tpu_torch.serving.engine import ServingEngine
    from mano_hand_tpu_torch.utils.devicelock import DeviceBusy, DeviceLock

    if _no_card(args, "serve"):
        return 2
    params = _load_params(args.asset, args.side, "cpu").astype(torch.float32)
    tracer = Tracer()
    tier_quotas = ({1: args.tier1_quota}
                   if args.max_queued and args.tier1_quota else None)
    # --store-warm-capacity N: the tiered store with a host-RAM warm tier
    # of N rows (sharded when the worker runs lanes — the shards ARE the
    # per-lane tables).
    store = None
    if args.store_warm_capacity:
        from mano_hand_tpu_torch.serving.subject_store import (
            SubjectStore, SubjectStoreConfig,
        )

        store = SubjectStore(SubjectStoreConfig(
            warm_capacity=int(args.store_warm_capacity),
            sharded=bool(args.lanes)))
    eng = ServingEngine(
        params,
        device=args.device,
        max_bucket=args.max_bucket,
        max_delay_s=args.max_delay_ms / 1e3,
        aot_dir=args.aot_dir or None,
        max_queued=args.max_queued or None,
        tier_quotas=tier_quotas,
        lanes=args.lanes or None,
        posed_kernel=args.posed_kernel,
        tracer=tracer,
        subject_store=store,
        max_subjects=args.max_subjects,
    )
    recorder = FlightRecorder(tracer, eng.counters,
                              out_dir=args.flight_dir or None)
    registry = engine_registry(eng, tracer=tracer)
    # --control: the closed-loop controller; its retry_after_for also
    # becomes the edge's 429 Retry-After source.
    ctl = None
    if args.control:
        from mano_hand_tpu_torch.serving.control import Controller

        ctl = Controller(eng, log=lambda m: print(
            f"control: {m}", file=sys.stderr))

    lock_mode = args.device_lock
    if lock_mode == "auto":
        lock_mode = "off" if args.device == "cpu" else "server"
    lock_ctx = (DeviceLock("server", log=lambda m: print(
        m, file=sys.stderr)) if lock_mode == "server"
        else contextlib.nullcontext())

    stop_evt = threading.Event()

    def _on_signal(signum, frame):
        print(f"signal {signum}: draining", file=sys.stderr)
        stop_evt.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    try:
        with lock_ctx:
            eng.start()
            if not args.no_warmup:
                eng.warmup()
            # --warm-streams: one synthetic stream (specialize, fit a
            # frame, close) BEFORE the ready line, so the first real
            # stream frame pays no first-use cost. Best-effort: a failure
            # logs and boots the worker cold rather than not at all.
            warmed = False
            if args.warm_streams:
                try:
                    sess = eng.open_stream(
                        np.zeros((params.n_shape,), np.float32))
                    try:
                        sess.submit_frame(
                            np.zeros((params.n_joints, 3), np.float32)
                        ).result(timeout=300)
                    finally:
                        sess.close()
                    warmed = True
                    print("warm-streams: stream-fit family warm",
                          file=sys.stderr)
                except Exception as e:  # noqa: BLE001 — cold > dead
                    print(f"warm-streams failed (worker boots cold): "
                          f"{type(e).__name__}: {e}", file=sys.stderr)
            if ctl is not None:
                ctl.start()
            srv = EdgeServer(
                eng, host=args.host, port=args.port, registry=registry,
                drain_timeout_s=args.drain_timeout_s,
                retry_after_source=(None if ctl is None
                                    else ctl.retry_after_for),
                warm_streams=warmed,
                log=lambda m: print(m, file=sys.stderr)).start()
            print(json.dumps({
                "edge": {"host": srv.host, "port": srv.port,
                         "pid": os.getpid(),
                         "device_lock": lock_mode}}), flush=True)
            # Interruptible wait: the signal handler runs on this main
            # thread between wait windows.
            while not stop_evt.wait(0.5):
                pass
            if ctl is not None:
                ctl.stop()      # before the drain: no actuation mid-sweep
            report = srv.drain(timeout_s=args.drain_timeout_s)
            report["incident_captures"] = len(recorder.captures)
            # The exit line carries the worker's tracer accounting and
            # build counters for a supervisor to aggregate.
            report["accounting"] = tracer.accounting()
            snap = eng.counters.snapshot()
            report["counters"] = {
                k: snap[k] for k in
                ("compiles", "aot_loads", "aot_load_failures")}
            # Port-only: this process's K2 and K2-bf16 launches beside its
            # gathered dispatches — a kernel launch in a worker process is
            # visible to its supervisor only here. For an f32 worker with
            # --posed-kernel fused on the card, K2 launches == gathered
            # dispatches + one eager warm call a captured gathered
            # program; bf16-tier batches, --posed-kernel xla and CPU-tier
            # failovers count as gathered dispatches without a K2 launch.
            # On the CPU the plain version runs (0 launches).
            from mano_hand_tpu_torch.ops import fused_posed

            report["launches"] = {
                "K2": fused_posed.launches,
                "K2_bf16": fused_posed.bf16_launches,
                "dispatches": snap["dispatches"],
                "dispatches_gathered": snap["dispatches_gathered"],
                "dispatches_bf16": snap["dispatches_bf16"]}
            print(json.dumps({"edge_exit": report}), flush=True)
    except DeviceBusy as e:
        print(f"device busy: {e}", file=sys.stderr)
        return 2
    return 0


def cmd_proxy(args) -> int:
    """``proxy`` — ONE member of the active/standby proxy pair: the
    proxy tier's single point of failure, made killable. It holds no
    device.

    Arbitration is the DeviceLock pattern at the socket level: both
    members run this command against the same ``--lock`` file; exactly
    one wins the EXCLUSIVE flock, binds the service ``--port``, and
    serves. The loser parks in a bounded-step, SIGTERM-interruptible
    ``LOCK_NB`` poll (never a C-level ``LOCK_EX`` wait — signal
    handlers need the main thread). When the active dies — SIGKILL
    included — the kernel releases its flock and the standby takes
    over: it reads+increments the takeover generation stored IN the
    lock file (under the flock), waits (bounded) for the corpse's port
    to free, rebuilds per-backend routing state from the workers' own
    ``/healthz`` (``EdgeProxy.resync_backends``), and serves. Live
    streams are not lost: clients reconnect through
    ``edge.client.ResilientStream``, which re-opens with
    ``resume_pose`` (the last-confirmed-pose protocol) against the new
    active.

    stdout contract (edge/fleet.py's ``ProxyPair`` parses it):
    a ready line at spawn ``{"proxy": {pid, port, role: "standby"}}``
    BEFORE the (possibly unbounded) park; on activation
    ``{"proxy_event": {event: "active", takeovers: N, port}}``; on
    SIGTERM a final ``{"proxy_exit": {...}}``. Logs go to stderr.
    """
    import errno
    import fcntl
    import os
    import signal
    import socket
    import threading
    import time as _time

    from mano_hand_tpu_torch.edge.proxy import Backend, EdgeProxy

    backends = []
    for spec in args.backend:
        name, _, hp = spec.partition("=")
        host, _, port = hp.rpartition(":")
        if not name or not host or not port.isdigit():
            print(f"--backend wants NAME=HOST:PORT, got {spec!r}",
                  file=sys.stderr)
            return 2
        backends.append(Backend(name, host, int(port)))
    if not backends:
        print("proxy needs at least one --backend NAME=HOST:PORT",
              file=sys.stderr)
        return 2

    stop_evt = threading.Event()

    def _on_signal(signum, frame):
        print(f"signal {signum}: proxy stopping", file=sys.stderr)
        stop_evt.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    # Ready line FIRST: the pair supervisor needs the pid before the
    # park, which lasts as long as the active lives.
    print(json.dumps({"proxy": {"pid": os.getpid(),
                                "port": int(args.port),
                                "role": "standby"}}), flush=True)

    fd = open(args.lock, "a+")
    try:
        while not stop_evt.is_set():
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError as e:
                if e.errno not in (errno.EAGAIN, errno.EACCES):
                    raise
                stop_evt.wait(0.05)
        if stop_evt.is_set():
            print(json.dumps({"proxy_exit": {
                "role": "standby", "served": False}}), flush=True)
            return 0

        # The takeover generation lives IN the lock file, mutated only
        # under the flock we now hold: generation 0 is the first-boot
        # active, N the Nth takeover winner.
        fd.seek(0)
        try:
            gen = int(json.loads(fd.read() or "{}").get(
                "takeovers", -1)) + 1
        except ValueError:
            gen = 0
        fd.seek(0)
        fd.truncate(0)
        fd.write(json.dumps({"takeovers": gen, "pid": os.getpid()}))
        fd.flush()

        # A SIGKILLed predecessor's listener closes with its process
        # (the same teardown that released the flock), but give the
        # kernel a bounded beat rather than crash-looping on EADDRINUSE.
        bind_deadline = _time.monotonic() + 10.0
        while not stop_evt.is_set():
            probe = socket.socket()
            probe.setsockopt(socket.SOL_SOCKET,
                             socket.SO_REUSEADDR, 1)
            try:
                probe.bind((args.host, int(args.port)))
                break
            except OSError as e:
                if _time.monotonic() > bind_deadline:
                    print(f"service port {args.port} never freed: {e}",
                          file=sys.stderr)
                    print(json.dumps({"proxy_exit": {
                        "role": "active", "takeovers": gen,
                        "error": f"bind: {e}"}}), flush=True)
                    return 1
                stop_evt.wait(0.05)
            finally:
                probe.close()
        if stop_evt.is_set():
            print(json.dumps({"proxy_exit": {
                "role": "standby", "served": False}}), flush=True)
            return 0

        proxy = EdgeProxy(
            backends, host=args.host, port=int(args.port),
            drain_timeout_s=args.drain_timeout_s,
            upstream_timeout_s=args.upstream_timeout_s,
            role="active", takeovers=gen,
            log=lambda m: print(m, file=sys.stderr))
        # Routing rebuild BEFORE the first proxied byte: a takeover
        # winner must not start with an empty breaker ledger aimed at
        # a dead worker. Bounded (concurrent, per-backend timeout).
        resynced = proxy.resync_backends(timeout_s=5.0)
        proxy.start()
        print(json.dumps({"proxy_event": {
            "event": "active", "takeovers": gen, "port": proxy.port,
            "backends_up": sum(1 for ok in resynced.values() if ok),
            "backends": len(resynced)}}), flush=True)
        while not stop_evt.wait(0.2):
            pass
        report = proxy.drain(timeout_s=args.drain_timeout_s)
        print(json.dumps({"proxy_exit": {
            "role": "active", "takeovers": gen, "drain": report,
            "counters": proxy._counter_dict()}}), flush=True)
        return 0
    finally:
        fd.close()                      # releases the flock if held


# The killable probe of one device type (``status --platforms``): a
# fresh interpreter names the device and moves one element to it and
# back. Prints "count type kind".
_STATUS_PROBE = (
    "import torch\n"
    "plat = {plat!r}\n"
    "if plat == 'cpu':\n"
    "    n, kind = 1, 'cpu'\n"
    "else:\n"
    "    assert torch.cuda.is_available(), 'CUDA is not available'\n"
    "    n, kind = torch.cuda.device_count(), "
    "torch.cuda.get_device_name(0)\n"
    "x = torch.ones(1, device=plat).cpu()\n"
    "assert float(x[0]) == 1.0\n"
    "print(n, plat, kind)\n"
)


def cmd_status(args) -> int:
    """``status`` — the operator's one-look health surface: host facts,
    device health, the committed numerics goldens, (``--server``) a live
    edge worker's ``/healthz`` and ``/metrics``, and (``--metrics-dir``)
    the last persisted metrics scrape of a ``serve-bench --metrics`` run,
    as one JSON document on stdout.

    Each device type of ``--platforms`` (``cpu``, ``cuda``, or
    ``default`` = the port's default, ``cuda``) is probed ONLY in a
    killable subprocess (``runtime.supervise.run_python``): a failed or
    hung probe degrades the report (``degraded: true``) instead of
    hanging the command; rc stays 0 — status is a report, not a gate.

    ``--prom`` re-renders the persisted metrics snapshot as Prometheus
    text (probes are skipped in that mode). The host block names
    ``torch`` (with ``torch.version.cuda``) and ``numpy`` where JAX's
    names ``jax``, ``jaxlib`` and ``numpy``."""
    from mano_hand_tpu_torch.obs.metrics import METRICS_JSON, prometheus_text
    from mano_hand_tpu_torch.obs.sentinel import (
        default_goldens_path, load_goldens,
    )

    metrics_snap = None
    metrics_info = None
    if args.metrics_dir:
        path = Path(args.metrics_dir) / METRICS_JSON
        try:
            metrics_snap = json.loads(path.read_text())
            metrics_info = {
                "path": str(path),
                "schema": metrics_snap.get("schema"),
                "metrics": len(metrics_snap.get("metrics") or {}),
                "wall_time_utc": metrics_snap.get("wall_time_utc"),
            }
        except (OSError, ValueError) as e:
            metrics_info = {"path": str(path),
                            "error": f"{type(e).__name__}: {e}"}
    if args.prom:
        if metrics_snap is None:
            print("--prom needs a readable --metrics-dir (the "
                  "persisted scrape of a `serve-bench --metrics DIR` "
                  "run)" + (f": {metrics_info['error']}"
                            if metrics_info else ""), file=sys.stderr)
            return 2
        print(prometheus_text(metrics_snap), end="")
        return 0

    host = {"python": sys.version.split()[0], "platform": sys.platform}
    from importlib import metadata

    for pkg in ("torch", "numpy"):
        try:
            host[pkg] = metadata.version(pkg)
        except Exception:  # noqa: BLE001 — a missing dist is a fact
            host[pkg] = None
    host["torch_cuda"] = torch.version.cuda

    from mano_hand_tpu_torch.runtime import supervise

    probes = {}
    degraded = False
    for plat in [p.strip() for p in args.platforms.split(",")
                 if p.strip()]:
        dev_type = "cuda" if plat == "default" else plat
        res = supervise.run_python(_STATUS_PROBE.format(plat=dev_type),
                                   timeout_s=args.probe_timeout)
        entry = {"ok": bool(res.ok)}
        if res.ok:
            parts = (res.out or "").splitlines()[-1].split(None, 2)
            if len(parts) == 3:
                entry.update(devices=int(parts[0]), platform=parts[1],
                             device_kind=parts[2])
        else:
            entry["error"] = res.err
            entry["killed"] = bool(getattr(res, "killed", False))
            degraded = True
        probes[plat] = entry

    server_block = None
    if args.server:
        # Probe a live edge worker: bounded (the client's socket timeout
        # covers connect and every read) and degrading (any failure is a
        # fact in the report, not a crash) — rc stays 0 either way.
        from urllib.parse import urlparse

        from mano_hand_tpu_torch.edge import EdgeClient

        spec = (args.server if "//" in args.server
                else f"http://{args.server}")
        u = urlparse(spec)
        server_block = {"url": args.server, "ok": False}
        cli = EdgeClient(u.hostname or "127.0.0.1", u.port or 8077,
                         timeout_s=args.server_timeout)
        try:
            h = cli.healthz()
            server_block["ok"] = bool(h.get("ok"))
            server_block["healthz"] = {
                k: h.get(k) for k in ("status", "degraded",
                                      "uptime_s", "breaker", "lanes")}
            server_block["engine"] = h.get("engine")
            server_block["streams"] = h.get("streams")
            if h.get("role") == "proxy":
                # A fleet front tier: its /healthz already carries the
                # bounded per-backend fan-out.
                server_block["role"] = "proxy"
                server_block["proxy_role"] = h.get("proxy_role")
                server_block["takeovers"] = h.get("takeovers")
                server_block["backends"] = {
                    name: {k: b.get(k) for k in
                           ("ok", "status", "degraded", "breaker",
                            "draining_via_proxy", "outstanding",
                            "streams", "stream_warm", "error")}
                    for name, b in (h.get("backends") or {}).items()}
                server_block["counters"] = h.get("counters")
            try:
                text = cli.metrics_text()
                server_block["metrics"] = {
                    "lines": len(text.splitlines()),
                    "has_serving": "mano_serving_" in text,
                }
                control = _control_from_prometheus(text)
                if control:
                    # Port-only: a worker's controller, read from its
                    # load_control_* gauges and control_* counters.
                    server_block["control"] = control
            except Exception as e:  # noqa: BLE001 — degrade per leg
                server_block["metrics"] = {
                    "error": f"{type(e).__name__}: {e}"}
        except Exception as e:  # noqa: BLE001 — down/hung server
            server_block["error"] = f"{type(e).__name__}: {e}"
        finally:
            cli.close()

    gpath = default_goldens_path()
    goldens = load_goldens(gpath)
    report = {
        "schema": 1,
        "host": host,
        "probes": probes,
        "degraded": degraded,
        "goldens": {
            "path": str(gpath),
            "present": goldens is not None,
            "entries": sorted((goldens or {}).get("entries", {})),
        },
    }
    if degraded:
        report["note"] = (
            "device probe failed/hung — host-only report (no card "
            "answered; a card engine cannot serve, a --device cpu one "
            "can)")
    if server_block is not None:
        report["server"] = server_block
    if metrics_info is not None:
        report["metrics"] = metrics_info
    if metrics_snap is not None:
        # The persisted scrape's streams block: live sessions and the
        # per-stream backlog age at one look.
        m = metrics_snap.get("metrics") or {}
        streams_block = {}
        for short in ("active", "frames_in_flight", "backlog_age_s",
                      "opened", "frames_submitted", "frames_resolved"):
            entry = m.get(f"load_streams_{short}")
            samples = (entry or {}).get("samples") or []
            if samples:
                streams_block[short] = samples[0][1]
        if streams_block:
            report["streams"] = streams_block
    print(json.dumps(report, indent=2))
    return 0


def cmd_analyze(args) -> int:
    """Project-invariant static analysis of the port (``analysis/``): the
    policy linter, the lock-discipline checker and (on the CPU, no card
    touched) the FX program auditor. Exit 0 iff clean; each failure names
    the rule, file:line and its escape hatch."""
    from mano_hand_tpu_torch.analysis.run import run_analysis

    return run_analysis(update_baseline=args.update_baseline,
                        skip_fx=args.skip_fx, as_json=args.json)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mano_hand_tpu_torch",
                                description=__doc__)
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="the device every subcommand runs on (default cuda; the "
             "port never falls back to the CPU on its own)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="export the reference demo mesh")
    d.add_argument("--asset", default="synthetic",
                   help="asset path (.npz/.pkl) or 'synthetic'")
    d.add_argument("--side", default=None, choices=SIDES)
    d.add_argument("--backend", default="torch", choices=["np", "torch"])
    d.add_argument("--out", default="hand.obj",
                   help="output mesh; a .ply suffix writes binary PLY "
                        "with normals instead of the OBJ pair")
    d.set_defaults(fn=cmd_demo)

    c = sub.add_parser("convert", help="convert assets between formats")
    c.add_argument("src")
    c.add_argument("dst", help="output path (.npz or .pkl)")
    c.add_argument("--side", default=None, choices=SIDES)
    c.add_argument("--mirror", action="store_true",
                   help="write the OPPOSITE side: reflect the asset "
                        "across x=0 (template/bases re-signed, winding "
                        "reversed, PCA stats mirrored — "
                        "assets.mirror_params); for when only one "
                        "side's file is at hand")
    c.set_defaults(fn=cmd_convert)

    a = sub.add_parser("animate", help="batch-evaluate a pose sequence")
    a.add_argument("poses", help=".npy of [T,16,3] or [T,15,3] axis-angles")
    a.add_argument("--asset", default="synthetic")
    a.add_argument("--side", default=None, choices=SIDES)
    a.add_argument("--out", default="frames",
                   help="output dir for OBJ frames, or a .glb path for "
                        "ONE viewer-ready animated file (morph targets)")
    a.add_argument("--fps", type=float, default=30.0,
                   help="playback rate for --out .glb")
    a.add_argument("--skinned", action="store_true",
                   help="with --out .glb: export a skeletal skin "
                        "(joint nodes + LBS weights + quaternion "
                        "rotation tracks — drivable in any engine) "
                        "instead of baked morph targets (exact but "
                        "frame-count-sized)")
    a.set_defaults(fn=cmd_animate)

    r = sub.add_parser("render", help="rasterize poses to PNG/GIF")
    r.add_argument("--poses", default=None,
                   help=".npy of [T,16,3]/[T,15,3]/[16,3]; default rest pose")
    r.add_argument("--asset", default="synthetic")
    r.add_argument("--side", default=None, choices=SIDES)
    r.add_argument("--out", default="render",
                   help="output dir for PNGs, or a .gif path")
    r.add_argument("--size", type=int, default=256)
    r.add_argument("--fps", type=int, default=20)
    r.set_defaults(fn=cmd_render)

    f = sub.add_parser(
        "fit",
        help="recover pose/shape from target verts, 3D joints, 2D "
             "keypoints, scan points, or segmentation masks",
    )
    f.add_argument("targets",
                   help=".npy of [V,3]/[B,V,3] verts; [16,3]/[B,16,3] "
                        "joints with --data-term joints; [16,2]/[B,16,2] "
                        "image points with --data-term keypoints2d; "
                        "[N,3]/[B,N,3] scan points with --data-term "
                        "points or point_to_plane (a .ply or .obj file "
                        "loads its vertex cloud directly); an "
                        "[H,W]/[B,H,W] .npy mask in [0,1] or a .png "
                        "with --data-term silhouette")
    f.add_argument("--pose-space", default=None,
                   choices=["aa", "pca", "6d"],
                   help="pose parameterization: axis-angle (both solvers' "
                        "native space — leaves the solver default alone), "
                        "PCA coefficients, or the 6D continuous rotation "
                        "representation (wrap-free; results decode back "
                        "to axis-angle). pca/6d imply the Adam solver; "
                        "keypoints2d defaults to pca when unset")
    f.add_argument("--data-term", default="verts",
                   choices=["verts", "joints", "keypoints2d", "points",
                            "point_to_plane", "silhouette", "depth"],
                   help="fit to a full target mesh, sparse 3D keypoints "
                        "(detector/mocap output), 2D keypoints projected "
                        "through a pinhole camera, a correspondence-"
                        "free point cloud (partial depth-sensor scans): "
                        "'points' = chamfer/point-to-point ICP, "
                        "'point_to_plane' = LM-only normal-distance "
                        "polish after a points fit, or a segmentation "
                        "mask ('silhouette': soft-IoU through the "
                        "differentiable rasterizer, weak-perspective "
                        "camera; multi-view fitting is a library/example "
                        "feature — see examples/12), or a sensor depth "
                        "image ('depth': [H,W] .npy in view-space "
                        "meters, <=0/NaN = no reading — the one "
                        "single-view image term that observes full 3D "
                        "translation; pinhole/--camera-k only)")
    f.add_argument("--init", default=None,
                   help="warm-start from a previous fit checkpoint (.npz "
                        "with pose/shape, e.g. a coarse --data-term joints "
                        "fit before --data-term points refinement: "
                        "chamfer/ICP plateau from a cold start). Works "
                        "with both solvers (Adam needs --pose-space aa)")
    f.add_argument("--robust", default="none", choices=["none", "huber"],
                   help="Huber-robust data term (bounded pull from "
                        "outlier points). Adam only")
    f.add_argument("--robust-scale", type=float, default=0.01,
                   help="Huber scale in data units (meters for 3D terms)")
    f.add_argument("--tips", default="",
                   help="extend joints/keypoints2d targets with fingertip "
                        "vertex picks: 'smplx' | 'manopth' (the standard "
                        "21-keypoint set); default: 16 joints only")
    f.add_argument("--keypoint-order", default="mano",
                   choices=["mano", "openpose"],
                   help="row ordering of 21-keypoint targets "
                        "(openpose = OpenPose/FreiHAND convention)")
    f.add_argument("--robust-weights", default="none",
                   choices=["none", "tukey", "geman"],
                   help="soft IRLS reweighting of ICP points by their "
                        "per-step distances (LM solver, points/"
                        "point_to_plane) — the graded-noise counterpart "
                        "of --trim's hard cut; they compose")
    f.add_argument("--trim", type=float, default=0.0,
                   help="trimmed-ICP fraction in [0, 1): reject this "
                        "fraction of the worst-matching scan points each "
                        "step (outlier defense; --solver lm with "
                        "--data-term points/point_to_plane only)")
    f.add_argument("--fit-trans", action="store_true",
                   help="fit a global translation too (uncentered "
                        "targets/scans; both solvers — the 2D keypoint "
                        "terms always fit it). Checkpoint gains a "
                        "'trans' array; --init may carry one")
    f.add_argument("--conf", default=None,
                   help=".npy of [16]/[B,16] keypoint confidences "
                        "(keypoints2d only)")
    f.add_argument("--camera-eye", default=None,
                   help="camera position 'x,y,z' looking at the origin "
                        "(keypoints2d only; default 0,0,-0.75; "
                        "conflicts with --camera-k)")
    f.add_argument("--focal", type=float, default=None,
                   help="pinhole focal in NDC units (keypoints2d only; "
                        "default 2.2; conflicts with --camera-k)")
    f.add_argument("--camera-k", default=None,
                   help="dataset calibration 'fx,fy,cx,cy' in pixels "
                        "(with --camera-size): keypoints2d targets are "
                        "then PIXEL coordinates; silhouette masks must "
                        "match the calibrated resolution")
    f.add_argument("--camera-size", default=None,
                   help="calibrated image size 'WxH' (with --camera-k)")
    f.add_argument("--camera-scale", type=float, default=None,
                   help="weak-perspective scale (silhouette only): NDC "
                        "units per meter (default 3.0)")
    f.add_argument("--camera-rot", default=None,
                   help="axis-angle view rotation 'x,y,z' of the "
                        "silhouette camera (silhouette only; "
                        "default 0,0,0)")
    f.add_argument("--sil-sigma", type=float, default=None,
                   help="rasterizer edge softness in pixels for the "
                        "silhouette/depth terms (default 1.0 — about "
                        "right; larger blurs the optimum itself, "
                        "measured in docs/roadmap.md)")
    f.add_argument("--pose-prior", default="l2",
                   choices=["l2", "mahalanobis"],
                   help="pose regularizer: isotropic L2 toward zero, or "
                        "the data-driven Mahalanobis energy toward the "
                        "asset's mean pose in PCA-whitened space "
                        "(adam solver, aa/pca pose spaces)")
    f.add_argument("--pose-prior-weight", type=float, default=None,
                   help="pose prior weight (default: 1e-4 for "
                        "keypoints2d, 1.0 for silhouette/depth — a "
                        "single image cannot pin articulation, 1e-3 for "
                        "--pose-prior mahalanobis, else 0)")
    f.add_argument("--joint-limits", default=None,
                   help=".npz with per-DOF axis-angle bounds (keys lo, "
                        "hi, each [45]; build with "
                        "objectives.pose_limits_from_corpus) — adds the "
                        "squared-hinge anatomical limit prior "
                        "(adam solver, aa/pca pose spaces)")
    f.add_argument("--joint-limit-weight", type=float, default=None,
                   help="weight of the joint-limit hinge (default 1.0; "
                        "only with --joint-limits)")
    f.add_argument("--restarts", type=int, default=0,
                   help="solve ONE problem from N inits (zero + the "
                        "closed-form Kabsch alignment on verts/joints "
                        "targets + anatomical samples) and keep the "
                        "best — for far-rotated or multi-modal targets; "
                        "single-problem targets only")
    f.add_argument("--shape-prior", type=float, default=None,
                   help="shape regularizer. adam: L2 prior weight (default "
                        "0 for verts, 1.0 for silhouette/depth, 1e-3 "
                        "for joints/keypoints2d). lm "
                        "with joints: Tikhonov residual-ROW weight, which "
                        "enters the least-squares loss SQUARED (default "
                        "0.1) — not numerically comparable to the adam "
                        "weight")
    f.add_argument("--asset", default="synthetic")
    f.add_argument("--side", default=None, choices=SIDES)
    f.add_argument("--solver", default=None, choices=["lm", "adam"],
                   help="default: lm for --data-term verts/point_to_plane, "
                        "adam for joints/keypoints2d/points/silhouette/"
                        "depth; lm also supports joints and points "
                        "(second-order ICP); keypoints2d/silhouette/depth "
                        "are adam-only, point_to_plane lm-only")
    f.add_argument("--steps", type=int, default=None,
                   help="default: 25 (lm) / 200 (adam)")
    f.add_argument("--lr", type=float, default=None,
                   help="adam learning rate (default 0.05; 0.02 for "
                        "keypoints2d, 0.01 for silhouette/depth; "
                        "adam only)")
    f.add_argument("--out", default="fit.npz")
    f.add_argument("--heatmap", default=None,
                   help="also export the fitted mesh with per-vertex "
                        "error colors (blue=0 -> red=max): a rendered "
                        "PNG, or with a .glb extension a 3D mesh with "
                        "COLOR_0 vertex colors any glTF viewer can orbit "
                        "(--data-term verts, single target)")
    f.set_defaults(fn=cmd_fit)

    e = sub.add_parser(
        "export-aot",
        help="serialize the forward (torch.export) for serving",
    )
    e.add_argument("--asset", default="synthetic")
    e.add_argument("--side", default=None, choices=SIDES)
    e.add_argument("--out", default="mano_fwd.torchexp")
    e.add_argument("--batch", type=int, default=0,
                   help="pin the batch size; default 0 = symbolic (any B)")
    e.add_argument("--tips", default="",
                   help="fingertip convention for baked-in keypoints "
                        "('smplx' | 'manopth'); default: 16 joints only")
    e.add_argument("--keypoint-order", default="mano",
                   choices=["mano", "openpose"])
    e.add_argument("--platforms", default="cpu",
                   help="comma-separated torch device types to export for "
                        "(cpu, cuda; each traced on its device); default "
                        "cpu")
    e.set_defaults(fn=cmd_export_aot)

    sb = sub.add_parser(
        "serve-bench",
        help="measure the bucketed micro-batching engine on a synthetic "
             "ragged request stream (one JSON line of serving metrics)",
    )
    sb.add_argument("--asset", default="synthetic")
    sb.add_argument("--side", default=None, choices=SIDES)
    sb.add_argument("--requests", type=int, default=256,
                    help="requests per measured pass")
    sb.add_argument("--min-rows", type=int, default=1)
    sb.add_argument("--max-rows", type=int, default=64,
                    help="request batch sizes are uniform in "
                         "[--min-rows, --max-rows]")
    sb.add_argument("--max-bucket", type=int, default=256)
    sb.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="coalescing window once a request is pending")
    sb.add_argument("--aot-dir", default="",
                    help="persistent executable lattice of the engine "
                         "(io/export_aot.py); empty = in-memory only")
    sb.add_argument("--chaos", default="",
                    help="inject a deterministic fault plan "
                         "(runtime/chaos.py spec, e.g. "
                         "'error@0-1,latency:0.2@4,hang@7') into the "
                         "engine's primary programs under supervised "
                         "dispatch, or 'drill' to run the full recovery "
                         "drill (serving/measure.py:recovery_drill_run) "
                         "and print its one-line artifact")
    sb.add_argument("--deadline-s", type=float, default=None,
                    help="per-batch supervised dispatch deadline used "
                         "with --chaos (hung batches are abandoned, "
                         "retried, then failed over to the CPU tier of a "
                         "--device cpu engine). Default: 30 for a --chaos "
                         "plan, the drill protocol's own 2 s for --chaos "
                         "drill")
    sb.add_argument("--emit-by", type=float, default=-1.0,
                    help="hard wall-clock deadline in seconds: emit a "
                         "null JSON line and hard-exit if the run hangs "
                         "(a wedged device call cannot be interrupted). "
                         "Default: 900 on the card, off with --device "
                         "cpu; 0 disables")
    sb.add_argument("--subjects", type=int, default=0,
                    help="run the MIXED-SUBJECT coalescing protocol "
                         "instead (serving/measure.py:coalesce_bench_run):"
                         " this many baked subjects submit an "
                         "interleaved pose-only stream through the "
                         "gathered engine dispatch, measured against the "
                         "per-subject-split baseline. 0 = the classic "
                         "full-path protocol")
    sb.add_argument("--overload", action="store_true",
                    help="run the OVERLOAD/saturation drill instead "
                         "(serving/measure.py:overload_drill_run): "
                         "bounded admission + per-request deadlines + "
                         "priority shedding under a burst submitter at "
                         "--overload-saturation x the measured service "
                         "rate. Saturation is throttled in-process "
                         "(chaos 'sat' plan)")
    sb.add_argument("--cold-start", action="store_true",
                    help="run the cold-start/restart drill instead "
                         "(serving/measure.py:cold_start_drill_run): "
                         "bake the lattice + subject checkpoint into a "
                         "drill-owned coldstart_drill/ subdir of "
                         "--aot-dir (required), kill mid-traffic, "
                         "cold-boot, and judge zero builds after "
                         "restore; does not compose with --chaos/"
                         "--subjects/--overload/--deadline-s")
    sb.add_argument("--overload-saturation", type=float, default=4.0,
                    help="offered-load multiple of the measured "
                         "service rate for --overload (criteria are "
                         "judged at >= 4x achieved)")
    sb.add_argument("--streams", type=int, default=0,
                    help="run the STREAMING-SESSION drill instead "
                         "(serving/measure.py:stream_drill_run): this "
                         "many concurrent per-user tracking sessions. "
                         "0 = off")
    sb.add_argument("--trace", default="",
                    help="request-lifecycle tracing: span every request "
                         "through an obs.Tracer and export the "
                         "Chrome-trace timeline + final flight record "
                         "into this directory (read it with "
                         "`trace-report DIR`). Composes with every "
                         "protocol; stdout stays one JSON line")
    sb.add_argument("--metrics", default="",
                    help="persist the run's final metrics-registry "
                         "scrape into this directory as metrics.json + "
                         "metrics.prom (read them with `status "
                         "--metrics-dir DIR [--prom]`). Default protocol "
                         "only (optionally under a --chaos plan)")
    sb.add_argument("--seed", type=int, default=0)
    sb.set_defaults(fn=cmd_serve_bench)

    sv = sub.add_parser(
        "serve",
        help="serve the engine over the edge wire protocol: "
             "forward/stream endpoints with QoS headers, 429 "
             "backpressure, /metrics + /healthz, SIGTERM drain")
    sv.add_argument("--host", default="127.0.0.1",
                    help="bind address (default loopback)")
    sv.add_argument("--port", type=int, default=8077,
                    help="bind port (0 = ephemeral; the bound port is "
                         "in the stdout ready line)")
    sv.add_argument("--asset", default="synthetic")
    sv.add_argument("--side", default=None, choices=SIDES)
    sv.add_argument("--max-bucket", type=int, default=64)
    sv.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="coalesce window (the latency/throughput "
                         "knob)")
    sv.add_argument("--max-queued", type=int, default=256,
                    help="bounded admission: outstanding cap; 0 = "
                         "unbounded (429s never fire)")
    sv.add_argument("--max-subjects", type=int, default=4096,
                    help="specialized-subject table ceiling; under "
                         "--lanes it also sizes the per-lane shard "
                         "tables (ceil(max-subjects / lanes))")
    sv.add_argument("--tier1-quota", type=int, default=0,
                    help="tier-1 admission quota (0 = the default: half "
                         "of max-queued)")
    sv.add_argument("--lanes", type=int, default=0,
                    help="dispatch lanes (0 = single-context dispatch)")
    sv.add_argument("--posed-kernel", default="xla",
                    choices=["xla", "fused"],
                    help="gathered pose-only program family: the plain "
                         "gathered program, or the hand-written kernel "
                         "(K2 on the card)")
    sv.add_argument("--aot-dir", default="",
                    help="executable lattice dir for a build-free boot")
    sv.add_argument("--store-warm-capacity", type=int, default=0,
                    help="tiered subject store: host-RAM warm tier of N "
                         "rows (sharded under --lanes); 0 = device-table "
                         "only")
    sv.add_argument("--no-warmup", action="store_true",
                    help="skip the boot-time bucket warm-up (builds "
                         "then land in the first requests)")
    sv.add_argument("--warm-streams", action="store_true",
                    help="exercise one synthetic stream fit before the "
                         "ready line")
    sv.add_argument("--control", action="store_true",
                    help="attach the closed-loop controller: live "
                         "quota/coalesce/ladder-bias/Retry-After actuation "
                         "off burn rates; a crash degrades to the static "
                         "flags above")
    sv.add_argument("--drain-timeout-s", type=float, default=15.0,
                    help="SIGTERM drain budget: in-flight requests "
                         "resolve, the engine stop() sweep runs, the "
                         "process exits inside this window")
    sv.add_argument("--flight-dir", default="",
                    help="persist flight-recorder incident captures "
                         "here (default: in-memory only)")
    sv.add_argument("--device-lock", default="auto",
                    choices=["auto", "server", "off"],
                    help="multi-worker coexistence: 'server' takes the "
                         "SHARED device lock (N workers coexist; an "
                         "exclusive benchmark lock or priority claim -> "
                         "rc 2); 'auto' = server on the card, off with "
                         "--device cpu")
    sv.set_defaults(fn=cmd_serve)

    px = sub.add_parser(
        "proxy",
        help="one member of the active/standby fleet-proxy pair: "
             "parks on an exclusive flock; the winner binds "
             "the service port, resyncs backend health from worker "
             "/healthz, and serves — a SIGKILLed active's kernel-"
             "released lock activates the standby with an incremented "
             "takeover generation")
    px.add_argument("--port", type=int, required=True,
                    help="the pair's stable service port (clients and "
                         "ResilientStream reconnect here across "
                         "takeovers)")
    px.add_argument("--host", default="127.0.0.1")
    px.add_argument("--lock", required=True,
                    help="flock arbitration file; also carries the "
                         "takeover generation (mutated only under the "
                         "flock)")
    px.add_argument("--backend", action="append", default=[],
                    metavar="NAME=HOST:PORT",
                    help="one worker address (repeatable)")
    px.add_argument("--drain-timeout-s", type=float, default=10.0)
    px.add_argument("--upstream-timeout-s", type=float, default=300.0)
    px.set_defaults(fn=cmd_proxy)

    i = sub.add_parser("info", help="print asset summary")
    i.add_argument("--asset", default="synthetic")
    i.add_argument("--side", default=None, choices=SIDES)
    i.set_defaults(fn=cmd_info)

    v = sub.add_parser(
        "verify",
        help="audit a MANO asset (official .pkl/.npz) against the public "
             "structural facts + numeric invariants; print canonical "
             "digests")
    v.add_argument("asset", help="asset path (.pkl official/dumped, .npz)")
    v.add_argument("--side", default=None, choices=SIDES)
    v.add_argument("--golden", default=None,
                   help="second asset to diff numerically (e.g. the .npz "
                        "converted from a known-good pickle)")
    v.add_argument("--expect", default=None,
                   help="expected combined sha256 (pin a verified digest "
                        "in CI)")
    v.add_argument("--json", action="store_true",
                   help="machine-readable report")
    v.set_defaults(fn=cmd_verify)

    tr = sub.add_parser(
        "trace-report",
        help="summarize a torch.profiler capture and/or an engine span "
             "export (torch_trace / write_trace_dir DIR) into one merged "
             "host+device report: top device ops + per-bucket/tier "
             "queue/dispatch/device/readback stage breakdown",
    )
    tr.add_argument("path", help="trace dir or one *.trace.json[.gz]")
    tr.add_argument("--top", type=int, default=15)
    tr.add_argument("--json", action="store_true",
                    help="machine-readable JSON instead of the tables")
    tr.add_argument("--all-tracks", action="store_true",
                    help="include host tracks even when a device track "
                         "exists")
    tr.set_defaults(fn=cmd_trace_report)

    st = sub.add_parser(
        "status",
        help="host + device health report (killable-subprocess device "
             "probes), committed numerics goldens, a live edge worker, "
             "and the last persisted metrics scrape",
    )
    st.add_argument("--platforms", default="cpu,default",
                    help="comma-separated device types to probe (cpu, "
                         "cuda; 'default' = the port's default, cuda) — "
                         "a failed or hung probe degrades the report, "
                         "never hangs it")
    st.add_argument("--probe-timeout", type=float, default=20.0,
                    help="per-device probe deadline in seconds; a hung "
                         "probe is SIGKILLed at the deadline")
    st.add_argument("--server", default="",
                    help="probe a running edge worker: hit its /healthz "
                         "+ /metrics with a bounded timeout and fold the "
                         "answer into the report — a down/hung server "
                         "degrades the block (rc stays 0, never hangs)")
    st.add_argument("--server-timeout", type=float, default=3.0,
                    help="per-read bound on the --server probe")
    st.add_argument("--metrics-dir", default="",
                    help="read the metrics.json a `serve-bench --metrics "
                         "DIR` run persisted and include it in the "
                         "report")
    st.add_argument("--prom", action="store_true",
                    help="print the persisted metrics snapshot as "
                         "Prometheus text instead of the JSON report "
                         "(requires --metrics-dir; skips the device "
                         "probes)")
    st.set_defaults(fn=cmd_status)

    an = sub.add_parser(
        "analyze",
        help="run the port's static-analysis pass (policy linter, "
             "lock-discipline checker, FX program auditor); exit 0 iff "
             "clean",
    )
    an.add_argument("--update-baseline", action="store_true",
                    help="recommit mano_hand_tpu_torch/analysis/"
                         "baseline.json (the FX op counts) after an "
                         "INTENTIONAL program change; justify the diff in "
                         "the PR")
    an.add_argument("--skip-fx", action="store_true",
                    help="skip the FX program auditor (the one checker "
                         "that traces; the AST checkers run in a second)")
    an.add_argument("--json", action="store_true",
                    help="one machine-readable JSON line instead of the "
                         "report")
    an.set_defaults(fn=cmd_analyze)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
