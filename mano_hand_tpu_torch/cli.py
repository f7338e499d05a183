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

``--device {cuda,cpu}`` (default ``cuda``) picks the device every
subcommand runs on, where the JAX CLI takes ``--platform``; ``demo
--backend`` is ``np`` (the float64 oracle) or ``torch``. ``export-aot``
exports for its own ``--platforms`` (device types, default ``cpu``).
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
