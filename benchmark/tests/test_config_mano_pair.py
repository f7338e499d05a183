"""``mano_pair``, MANO's two hands, at MANO's published widths and tree."""

import pytest

from benchmark.tests.mano_widths import ALTERED, check_mano, config

NAME = "mano_pair"


def test_holds_manos_widths():
    check_mano(config(NAME))


@pytest.mark.parametrize("changes", ALTERED.values(), ids=list(ALTERED))
def test_refuses_other_widths(changes):
    """Altered so that it still holds together, it is refused all the
    same: the pin does not weaken."""
    with pytest.raises(AssertionError):
        check_mano(dict(config(NAME), **changes))
