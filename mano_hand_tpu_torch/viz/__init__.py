"""Visualisation: the cameras, the hard and soft rasterisers and the
image and video writers.

The port of the JAX package's ``viz/``: pinhole, weak-perspective and
calibrated (K-matrix) cameras; a z-buffer triangle rasteriser with
Lambert shading and per-vertex colours (fit-error heatmaps through
``error_colormap``); the differentiable soft silhouette and soft depth
renders the fitting terms consume, on the hard rasteriser's NDC -> pixel
mapping so masks, depth maps and shaded renders line up pixel for pixel;
and standard-library PNG/GIF/AVI writers. Renders run on the device of
the vertices they are given.
"""

from mano_hand_tpu_torch.viz.camera import (
    Camera,
    IntrinsicsCamera,
    WeakPerspectiveCamera,
    default_hand_camera,
    from_intrinsics,
    look_at,
    view_rotation,
)
from mano_hand_tpu_torch.viz.render import (
    error_colormap,
    render_mesh,
    render_sequence,
)
from mano_hand_tpu_torch.viz.silhouette import soft_depth, soft_silhouette
from mano_hand_tpu_torch.viz.png import write_png, write_gif
from mano_hand_tpu_torch.viz.avi import write_avi, read_avi_info

__all__ = [
    "Camera",
    "IntrinsicsCamera",
    "WeakPerspectiveCamera",
    "from_intrinsics",
    "look_at",
    "view_rotation",
    "error_colormap",
    "render_mesh",
    "render_sequence",
    "soft_depth",
    "soft_silhouette",
    "write_png",
    "write_gif",
    "write_avi",
    "read_avi_info",
]
