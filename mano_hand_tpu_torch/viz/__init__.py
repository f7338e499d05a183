"""Cameras for the port (the rasterisers come with rendering)."""

from mano_hand_tpu_torch.viz.camera import (
    Camera,
    IntrinsicsCamera,
    WeakPerspectiveCamera,
    default_hand_camera,
    from_intrinsics,
    look_at,
    view_rotation,
)

__all__ = [
    "Camera", "IntrinsicsCamera", "WeakPerspectiveCamera",
    "default_hand_camera", "from_intrinsics", "look_at", "view_rotation",
]
