"""The smoke's ``examples`` phase (``chip_smoke.examples``) rehearsed on
the CPU with example 06 in process and 01 in a worker process: 01's OBJ
held against the oracle, 06's three K4 routes against K4's plain version
and the oracle (no launch on the CPU: the wrappers run the plain
version), and 01 with no device flag in a fresh process refusing, naming
``--device cpu``."""

import torch.distributed as dist

import chip_smoke
from mano_hand_tpu_torch.ops import fused_forward
from torch_examples_run import torch_threads


def test_chip_smoke_examples_phase_rehearsed_on_the_cpu():
    import torch

    def zero_counts():
        fused_forward.launches = fused_forward.blend_skin_launches = 0

    def counts():
        return {"K1": fused_forward.launches,
                "K4": fused_forward.blend_skin_launches}

    with torch_threads(1):
        line = chip_smoke.examples(
            torch.device("cpu"), "cpu", counts, zero_counts,
            only=("01_quickstart", "06_fast_inference"))
    assert sorted(line["examples"]) == ["01_quickstart", "06_fast_inference"]
    assert line["examples"]["01_quickstart"]["figure"] <= 1e-5
    assert line["k4"]["rows"] == 64 and line["k4"]["launches"] == 0
    for route in ("fused", "chunked", "sharded"):
        assert line["k4"][route]["max_abs_err_plain"] <= 1e-5
        assert line["k4"][route]["max_abs_err_oracle"] <= 1e-4
    assert line["default_device"]["rc"] != 0
    assert "--device cpu" in line["default_device"]["said"]
    assert not dist.is_initialized()
