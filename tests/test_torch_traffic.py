"""The port's traffic traces (``mano_hand_tpu_torch/serving/traffic.py``)
against the JAX package's ``serving/traffic.py``.

The control drill's determinism receipt is the sha256 of ``serialize()``,
so the port's bytes must be JAX's: for every kind and three seeds the
serialized trace is byte-identical, ``trace_stats`` equal, and a bad
spec raises the same exception type. JAX's own traffic cases
(``tests/test_control.py``) run on the port's module too.
"""

import pytest

from mano_hand_tpu.serving import traffic as jtraffic
from mano_hand_tpu_torch.serving import traffic

KW = dict(duration_s=3.0, base_hz=40.0, peak_hz=400.0, tier0_fraction=0.3)


def test_trace_kinds_are_jax_s():
    assert traffic.TRACE_KINDS == jtraffic.TRACE_KINDS


@pytest.mark.parametrize("seed", [0, 7, 11])
@pytest.mark.parametrize("kind", ["diurnal", "bursty", "flash_crowd"])
def test_serialize_is_byte_identical_to_jax(kind, seed):
    ours = traffic.make_trace(kind, seed=seed, **KW)
    theirs = jtraffic.make_trace(kind, seed=seed, **KW)
    assert traffic.serialize(ours) == jtraffic.serialize(theirs)
    assert traffic.trace_stats(ours) == jtraffic.trace_stats(theirs)


def test_drill_shaped_flash_crowd_is_byte_identical_to_jax():
    """The control drill's own knobs: a 2.5 s flash crowd at a 15 %
    tier-0 share, the crowd at 35 % of the window."""
    kw = dict(seed=7, duration_s=2.5, base_hz=150.0, peak_hz=1200.0,
              tier0_fraction=0.15, crowd_at_fraction=0.35)
    a = traffic.serialize(traffic.make_trace("flash_crowd", **kw))
    b = jtraffic.serialize(jtraffic.make_trace("flash_crowd", **kw))
    assert a == b


@pytest.mark.parametrize("bad", [
    dict(kind="tsunami"), dict(duration_s=0.0), dict(base_hz=0.0),
    dict(base_hz=500.0), dict(tier0_fraction=1.5), dict(tier0_fraction=-0.1),
], ids=["kind", "duration", "base_zero", "base_over_peak", "tier0_high",
        "tier0_low"])
def test_validation_errors_match_jax(bad):
    kw = dict(kind="diurnal", seed=0, duration_s=1.0, base_hz=10.0,
              peak_hz=100.0, tier0_fraction=0.5)
    kw.update(bad)
    kind = kw.pop("kind")
    with pytest.raises(Exception) as ours:
        traffic.make_trace(kind, **kw)
    with pytest.raises(Exception) as theirs:
        jtraffic.make_trace(kind, **kw)
    assert type(ours.value) is type(theirs.value) is ValueError
    assert str(ours.value) == str(theirs.value)


def test_empty_trace_stats_match_jax():
    assert traffic.trace_stats(()) == jtraffic.trace_stats(())
    assert traffic.serialize(()) == jtraffic.serialize(())


# ------------------------------------------- JAX's traffic cases, on the port
def test_traffic_same_seed_is_byte_identical():
    kw = dict(seed=11, **KW)
    for kind in traffic.TRACE_KINDS:
        a = traffic.serialize(traffic.make_trace(kind, **kw))
        b = traffic.serialize(traffic.make_trace(kind, **kw))
        assert a == b, kind
        assert a != traffic.serialize(traffic.make_trace(
            kind, **{**kw, "seed": 12}))


def test_traffic_traces_are_valid_and_shaped():
    tr = traffic.make_trace("flash_crowd", seed=7, duration_s=2.0,
                            base_hz=40.0, peak_hz=400.0,
                            tier0_fraction=0.25, crowd_at_fraction=0.4)
    ts = [t for t, _ in tr]
    assert ts == sorted(ts)
    assert all(0.0 <= t < 2.0 for t in ts)
    assert {tier for _, tier in tr} <= {0, 1}
    st = traffic.trace_stats(tr)
    assert st["arrivals"] == len(tr) == st["tier0"] + st["tier1"]
    # The crowd is real: peak rate well above the base rate.
    assert st["peak_rate_hz"] > 3 * 40.0
    # Tier split tracks the requested fraction (binomial, wide margin).
    assert 0.1 < st["tier0"] / st["arrivals"] < 0.45
