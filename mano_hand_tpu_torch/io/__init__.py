"""Mesh and array I/O: OBJ (with the native C++ writer, ``io/native.py``),
PLY and ``.npz`` checkpoints (``io/checkpoints.py``, imported on demand).
Host-side: tensors are copied to the host and written from NumPy. The
serving engine's persistence, also imported on demand: the ahead-of-time
export and the executable lattice (``io/export_aot.py``) and the
warm-state checkpoints (``io/state_ckpt.py``)."""

from mano_hand_tpu_torch.io.obj import (
    export_obj,
    export_obj_pair,
    export_obj_sequence,
    format_obj,
    read_obj,
    restpose_path,
)
from mano_hand_tpu_torch.io.ply import PlyMesh, export_ply, read_ply

__all__ = [
    "PlyMesh",
    "export_obj",
    "export_obj_pair",
    "export_obj_sequence",
    "export_ply",
    "format_obj",
    "read_obj",
    "read_ply",
    "restpose_path",
]
