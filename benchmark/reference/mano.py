"""The plain MANO forward: the reference every cell is judged by.

Romero, Tzionas and Black, "Embodied Hands" (SIGGRAPH Asia 2017): shape
blendshapes, joint regression, Rodrigues rotations, pose-corrective
blendshapes driven by (R - I) of the 15 articulated joints, forward
kinematics over the tree, linear blend skinning. Written from the
paper's equations in plain torch (4x4 homogeneous transforms, matrix
products), in float64 by default, a block of rows at a time so that it
fits beside a run's state. It imports nothing of the program and reads
only the arrays the benchmark made.

``precision="tf32"`` computes it in float32 with TF32 matrix products:
the control, the nearest precision below the configuration's IEEE fp32,
which a correct run must beat.
"""

from __future__ import annotations

import contextlib

import torch

#: Below this angle (radians) the rotation is I + skew(r), exact to
#: float64 rounding.
_SMALL_ANGLE = 1e-8


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Run the block's float32 matrix products in ``precision``
    ("float64" and "ieee" leave them IEEE; "tf32" allows TF32), restored
    on exit through the API the caller's setting was made with."""
    target = "high" if precision == "tf32" else "highest"
    try:
        saved = ("legacy", torch.get_float32_matmul_precision())
        torch.set_float32_matmul_precision(target)
    except RuntimeError:   # the caller set it through torch.backends
        saved = ("backend", torch.backends.cuda.matmul.fp32_precision)
        torch.backends.cuda.matmul.fp32_precision = (
            "tf32" if precision == "tf32" else "ieee")
    try:
        yield
    finally:
        if saved[0] == "legacy":
            torch.set_float32_matmul_precision(saved[1])
        else:
            torch.backends.cuda.matmul.fp32_precision = saved[1]


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3]:
    R = I + sin(t) K + (1 - cos(t)) K^2 for the unit axis's skew K."""
    theta = aa.norm(dim=-1, keepdim=True)
    small = theta < _SMALL_ANGLE
    axis = aa / torch.where(small, torch.ones_like(theta), theta)
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    k = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                    dim=-1).reshape(*aa.shape[:-1], 3, 3)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    s = torch.sin(theta)[..., None]
    c = (1 - torch.cos(theta))[..., None]
    rot = eye + s * k + c * (k @ k)
    # Near zero: I + skew(r), the first order of the series.
    x, y, z = aa.unbind(-1)
    zero = torch.zeros_like(x)
    k_small = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                          dim=-1).reshape(*aa.shape[:-1], 3, 3)
    return torch.where(small[..., None], eye + k_small, rot)


def forward(arrays: dict, pose: torch.Tensor, shape: torch.Tensor,
            precision: str = "float64") -> torch.Tensor:
    """Vertices [B, V, 3] of ``pose`` [B, J, 3] and ``shape`` [B, S] in
    ``precision`` ("float64", "ieee" float32, or "tf32")."""
    dt = torch.float64 if precision == "float64" else torch.float32
    with matmul_precision(precision):
        return _forward(arrays, pose.to(dt), shape.to(dt), dt)


def _forward(arrays, pose, shape, dt):
    v_template = arrays["v_template"].to(dt)
    shape_basis = arrays["shape_basis"].to(dt)
    pose_basis = arrays["pose_basis"].to(dt)
    j_regressor = arrays["j_regressor"].to(dt)
    lbs_weights = arrays["lbs_weights"].to(dt)
    parents = arrays["parents"]
    b, j = pose.shape[0], pose.shape[1]
    v = v_template.shape[0]

    # Shape blendshapes and joint regression.
    v_shaped = v_template + (shape @ shape_basis.reshape(v * 3, -1).T
                             ).reshape(b, v, 3)
    joints = j_regressor @ v_shaped                          # [B, J, 3]
    # Pose correctives from (R - I) of the articulated joints.
    rot = rodrigues(pose)                                    # [B, J, 3, 3]
    eye = torch.eye(3, dtype=dt, device=pose.device)
    feat = (rot[:, 1:] - eye).reshape(b, -1)                 # [B, 9(J-1)]
    v_posed = v_shaped + (feat @ pose_basis.reshape(v * 3, -1).T
                          ).reshape(b, v, 3)
    # Forward kinematics in homogeneous 4x4 transforms.
    rel = torch.cat([joints[:, :1],
                     joints[:, 1:] - joints[:, list(parents[1:])]], dim=1)
    bottom = torch.zeros(b, j, 1, 4, dtype=dt, device=pose.device)
    bottom[..., 3] = 1
    local = torch.cat([torch.cat([rot, rel[..., None]], dim=-1), bottom],
                      dim=-2)                                # [B, J, 4, 4]
    world = [local[:, 0]]
    for i in range(1, j):
        world.append(world[parents[i]] @ local[:, i])
    world = torch.stack(world, dim=1)
    # Remove the rest pose: A = G [I | -J_rest], kept as its 3x4 rows.
    world_rot, world_t = world[..., :3, :3], world[..., :3, 3]
    skin_t = world_t - (world_rot @ joints[..., None])[..., 0]
    a = torch.cat([world_rot, skin_t[..., None]], dim=-1)    # [B, J, 3, 4]
    # Linear blend skinning.
    blended = (lbs_weights @ a.reshape(b, j, 12)).reshape(b, v, 3, 4)
    return (blended[..., :3] @ v_posed[..., None])[..., 0] + blended[..., 3]


def forward_blocks(arrays: dict, pose: torch.Tensor, shape: torch.Tensor,
                   precision: str = "float64", block: int = 4096):
    """Yield ``(lo, hi, verts[lo:hi])`` over the rows, ``block`` at a
    time, so the reference fits beside a run's state."""
    for lo in range(0, pose.shape[0], block):
        hi = min(lo + block, pose.shape[0])
        yield lo, hi, forward(arrays, pose[lo:hi], shape[lo:hi], precision)
