"""The port's host model (models/splats.py's SplatModelHost) against the
JAX package's: push_back, copy and from_device on one seeded sequence of
calls give the same arrays, the same count and the same errors with the
same messages; from_device copies a port SplatModel (on the card too:
chip_smoke phase 21's export goes through it) and equals its to_host."""

import numpy as np
import pytest

from gaussian_splatterer_tpu.models.splats import SplatModelHost as JHost
from gaussian_splatterer_tpu_torch.models.splats import SplatModelHost as THost

FIELDS = ("means", "shs", "scales", "opacities", "rotations")


def _calls(seed: int, capacity: int, k: int):
    """A seeded list of (method, args): push_backs past the capacity and
    copies inside and outside the bounds."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(4 * capacity + 4):
        if rng.random() < 0.7:
            calls.append(("push_back", (rng.normal(size=3), rng.normal(size=(k * 3,)),
                                        rng.uniform(0.01, 1, 3), float(rng.uniform()),
                                        rng.normal(size=4))))
        else:
            calls.append(("copy", (int(rng.integers(-2, capacity + 2)),
                                   int(rng.integers(-2, capacity + 2)))))
    return calls


def _run(host, calls):
    """Apply ``calls`` to ``host``; each call's error type and message, or
    None."""
    out = []
    for name, args in calls:
        try:
            getattr(host, name)(*args)
            out.append(None)
        except Exception as exc:  # noqa: BLE001 (the messages are compared)
            out.append((type(exc).__name__, str(exc)))
    return out


def _same(t, j):
    assert (t.capacity, t.count, t.sh_degree, t.sh_coeffs) == \
        (j.capacity, j.count, j.sh_degree, j.sh_coeffs)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        assert getattr(t, f).dtype == getattr(j, f).dtype


@pytest.mark.parametrize("capacity,degree,k", [(6, 1, 4), (9, 3, 16), (1, 0, 1)])
def test_push_back_and_copy_equal_jax(capacity, degree, k):
    calls = _calls(capacity * 7 + k, capacity, k)
    t, j = THost(capacity, degree, k), JHost(capacity, degree, k)
    errors = _run(t, calls)
    assert errors == _run(j, calls)
    assert ("RuntimeError", "Model ran out of capacity!") in errors
    assert ("RuntimeError", "Can't copy splat in model, incorrect bounds!") in errors
    _same(t, j)


def test_errors_and_messages():
    t = THost(2, 1, 4)
    with pytest.raises(RuntimeError, match="^Can't copy splat in model, incorrect bounds!$"):
        t.copy(0, 0)  # nothing pushed yet
    for _ in range(2):
        t.push_back((1, 2, 3), np.arange(12), (0.1, 0.2, 0.3), 0.5, (1, 0, 0, 0))
    with pytest.raises(RuntimeError, match="^Model ran out of capacity!$"):
        t.push_back((1, 2, 3), np.arange(12), (0.1, 0.2, 0.3), 0.5, (1, 0, 0, 0))
    with pytest.raises(RuntimeError, match="incorrect bounds"):
        t.copy(2, 0)
    with pytest.raises(ValueError):  # the coefficients are reshaped to (sh_coeffs, 3)
        THost(2, 1, 4).push_back((0, 0, 0), np.arange(9), (1, 1, 1), 1.0, (1, 0, 0, 0))
    t.copy(1, 0)
    assert t.shs[1].tolist() == np.arange(12, dtype=np.float32).reshape(4, 3).tolist()


def test_from_device_equals_jax_on_the_same_arrays():
    """A port model and a JAX model built from the same host model come
    back equal through from_device, and the port's equals its to_host."""
    calls = _calls(3, 8, 4)
    t, j = THost(8, 1, 4), JHost(8, 1, 4)
    _run(t, calls)
    _run(j, calls)
    model = t.to_device("cpu")
    back = THost.from_device(model)
    _same(back, JHost.from_device(j.to_device()))
    _same(back, model.to_host())
    model.means.data[0, 0] = 123.0  # from_device copied, it does not alias
    assert back.means[0, 0] != 123.0

