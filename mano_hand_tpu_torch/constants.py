"""Model-family constants for the MANO hand.

The shape contract of the MANO asset: 16 joints, 778 vertices, 1538
faces, 10 shape coefficients, 45 axis-angle pose dims (15 articulated
joints x 3), and 135 pose-corrective blendshape dims (15 x 9
rotation-matrix deltas).
"""

N_VERTS = 778
N_JOINTS = 16
N_FACES = 1538
N_SHAPE = 10
N_POSE_JOINTS = N_JOINTS - 1          # articulated joints (wrist excluded)
N_POSE_AXISANGLE = N_POSE_JOINTS * 3  # 45: flattened finger axis-angles
N_POSE_BASIS = N_POSE_JOINTS * 9      # 135: (R - I) rotation-matrix deltas

# The MANO kinematic tree (root = wrist), topologically ordered so every
# parent index precedes its children. Root's parent is -1.
MANO_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)

LEFT = "left"
RIGHT = "right"
# Body-family assets are unsided.
NEUTRAL = "neutral"

# The SMPL-H kinematic tree: 22 body joints (SMPL order), then 15
# left-hand joints rooted at the left wrist (20), then 15 right-hand
# joints at the right wrist (21). The widest tree of the SMPL family, and
# one whose levels do not align with index order.
SMPLH_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
    18, 19,
    20, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35,
    21, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50,
)

# The SMPL-X kinematic tree (``kintree_table`` row 0 of the official
# SMPLX_NEUTRAL.npz): pelvis, 21 body joints, jaw, two eyes, then 15
# left-hand and 15 right-hand joints; 55 joints in 11 levels.
SMPLX_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
    18, 19,
    15, 15, 15,
    20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
)

# ---------------------------------------------------------------- keypoints
# The MANO skeleton regresses 16 joints and no fingertips (the tips are
# mesh surface, not skeleton). Hand-pose datasets and detectors (FreiHAND,
# HO-3D, InterHand2.6M, OpenPose/MediaPipe) use 21 keypoints: the 16
# joints plus one fingertip per finger, each a fixed vertex of the
# official 778-vertex mesh. Two vertex-id conventions circulate in the
# torch ecosystem; both are provided. Order within each tuple: (thumb,
# index, middle, ring, pinky).
TIP_VERTEX_IDS = {
    "smplx": (744, 320, 443, 554, 671),    # smplx VertexJointSelector
    "manopth": (745, 317, 444, 556, 673),  # manopth ManoLayer tips
}

# MANO's 16 joints are ordered wrist, index(3), middle(3), pinky(3),
# ring(3), thumb(3) — the kinematic-tree order of MANO_PARENTS above. With
# the 5 tips appended (thumb..pinky, indices 16..20), this permutation
# re-orders the 21 keypoints into the OpenPose/FreiHAND convention
# (wrist, thumb CMC->tip, index MCP->tip, middle, ring, pinky):
# openpose[i] = mano21[MANO21_TO_OPENPOSE[i]].
MANO21_TO_OPENPOSE = (
    0,
    13, 14, 15, 16,   # thumb chain + tip
    1, 2, 3, 17,      # index
    4, 5, 6, 18,      # middle
    10, 11, 12, 19,   # ring
    7, 8, 9, 20,      # pinky
)
