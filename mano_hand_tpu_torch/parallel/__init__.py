"""Multi-device placement. So far only ``lane_devices``, the devices the
serving engine's dispatch lanes run on."""

from mano_hand_tpu_torch.parallel.mesh import lane_devices

__all__ = ["lane_devices"]
