"""The dephased transport's kernel wrapper (``ops/bloch_kernel``) on the CPU.

* ``lz/kernel.propagate_bloch`` on CPU tensors is the plain tree, bit for
  bit, and launches nothing; so are the dephased and thermal passes of a
  sweep, which emit no ``lz.dephase.kernel`` span.
* The wrapper imports, and names its source and the program it replaces,
  without ``nvcc`` or a card; given CPU tensors it runs the plain version
  on whatever the tree takes, and its launch checks refuse what the kernel
  does not take.
* A chunk of speeds is sized by what it stages: the tree's leaves, or on
  the card the dephased kernel's output alone.
* The span ``lz.dephase.kernel`` is one of ``utils/profiling.SPANS``.

The kernel itself runs on the card only
(``tests/test_torch_bloch_kernel_gpu.py``).
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bdlz_tpu_torch.lz import kernel as lk
from bdlz_tpu_torch.lz.profile import BounceProfile
from bdlz_tpu_torch.lz.sweep_bridge import probabilities_for_points
from bdlz_tpu_torch.lz.thermal import thermal_probabilities_for_points
from bdlz_tpu_torch.ops import _build
from bdlz_tpu_torch.ops import bloch_kernel as bk
from bdlz_tpu_torch.utils import profiling

F64 = torch.float64


def _profile(n_seg=40):
    xi = np.linspace(-12.0, 12.0, n_seg + 1)
    return BounceProfile(xi=xi, delta=np.tanh(xi / 2.0) + 0.05 * np.sin(xi),
                         mix=0.08 * (1.0 + 0.2 * np.cos(xi / 2.0)))


@pytest.fixture
def launches():
    bk.reset_launches()
    yield bk.LAUNCHES
    bk.reset_launches()


@pytest.mark.parametrize("gamma", [0.0, 0.05, -0.3, "per_speed"])
def test_propagate_bloch_on_the_cpu_is_the_plain_tree(launches, gamma):
    if gamma == "per_speed":
        gamma = torch.linspace(-0.1, 0.3, 33, dtype=F64)
    a, b, dxi = lk._segment_hamiltonians(_profile(), "cpu")
    v = torch.linspace(0.05, 0.95, 33, dtype=F64)
    rates = torch.as_tensor(gamma, dtype=F64).expand(v.shape)
    got = lk.propagate_bloch(a, b, dxi, v, gamma)
    assert torch.equal(got, lk.propagate_bloch_plain(a, b, dxi, v, rates))
    assert torch.equal(got, bk.bloch_transport(a, b, dxi, v, rates))
    assert launches["bloch"] == 0


def test_a_negative_rate_is_no_rate(launches):
    a, b, dxi = lk._segment_hamiltonians(_profile(), "cpu")
    v = torch.linspace(0.1, 0.9, 5, dtype=F64)
    assert torch.equal(bk.bloch_transport(a, b, dxi, v, torch.full_like(v, -1.0)),
                       bk.bloch_transport(a, b, dxi, v, torch.zeros_like(v)))
    assert torch.equal(lk.propagate_bloch(a, b, dxi, v, -1.0),
                       lk.propagate_bloch(a, b, dxi, v, 0.0))
    rates = torch.tensor([-1.0, 0.05, -0.2, 0.0, 0.05], dtype=F64)
    assert torch.equal(bk.bloch_transport(a, b, dxi, v, rates),
                       bk.bloch_transport(a, b, dxi, v, torch.clamp_min(rates, 0.0)))


def test_cpu_passes_launch_nothing_and_emit_no_kernel_span(launches):
    prof = _profile()
    v = np.linspace(0.05, 0.95, 24)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        probabilities_for_points(prof, v, method="dephased", gamma_phi=0.05, device="cpu")
        thermal_probabilities_for_points(prof, np.tile(v, 2), np.repeat([40.0, 200.0], 24),
                                         0.001, 50.0, device="cpu")
    names = [e.name() for e in p.profiler.kineto_results.events()]
    # one pass for the dephased estimator, one for the thermal scenario's
    # two rates
    assert names.count("lz.dephase") == 2
    assert "lz.dephase.kernel" not in names
    assert launches["bloch"] == 0


def test_the_wrapper_imports_without_a_card_or_nvcc():
    # the import built nothing: the library loads at the first CUDA launch
    assert bk.load_library.cache_info().currsize == 0
    assert (_build.CSRC_DIR / bk.SOURCE).is_file()
    assert set(bk.LAUNCHES) == set(bk.KERNELS) == {"bloch"}
    entry, replaces = bk.KERNELS["bloch"]
    assert entry == "bloch_transport"
    assert replaces.startswith("bdlz_tpu/lz/kernel.py:192") and "no pallas_call" in replaces


def _bad_inputs(case):
    """(a, b, dxi, v, rates) with one input the kernel does not take."""
    a, b, dxi = lk._segment_hamiltonians(_profile(), "cpu")
    v = torch.linspace(0.1, 0.9, 8, dtype=F64)
    g = torch.full((8,), 0.05, dtype=F64)
    return {
        "float32": (a, b, dxi, v.float(), g),
        "strided": (a, b, dxi, torch.stack([v, v], 1)[:, 0], g),
        "2-D": (a, b, dxi, v[None], g),
        "lengths": (a, b[:-1], dxi, v, g),
        "devices": (a.to("meta"), b, dxi, v, g),
        "rate_float32": (a, b, dxi, v, g.float()),
        "rate_length": (a, b, dxi, v, g[:-1]),
        "rate_device": (a, b, dxi, v, g.to("meta")),
    }[case]


@pytest.mark.parametrize("case", ["float32", "strided", "2-D", "lengths", "devices",
                                  "rate_float32", "rate_length", "rate_device"])
def test_the_launch_checks_refuse_what_the_kernel_does_not_take(case):
    with pytest.raises((TypeError, ValueError)):
        bk._check(*_bad_inputs(case))


@pytest.mark.parametrize("case", ["float32", "strided"])
def test_the_cpu_path_takes_what_the_tree_takes(launches, case):
    args = _bad_inputs(case)
    assert torch.equal(bk.bloch_transport(*args), lk.propagate_bloch_plain(*args))
    assert launches["bloch"] == 0


@pytest.mark.parametrize("n_rates", [1, 7, 9])
def test_a_rate_for_each_speed_or_none_on_the_cpu_too(n_rates):
    # one rate per speed, as the kernel's launch check asks: a lone rate
    # is not broadcast
    a, b, dxi = lk._segment_hamiltonians(_profile(), "cpu")
    v = torch.linspace(0.1, 0.9, 8, dtype=F64)
    with pytest.raises(ValueError, match="one rate per speed"):
        bk.bloch_transport(a, b, dxi, v, torch.full((n_rates,), 0.05, dtype=F64))


@pytest.mark.parametrize("method,device,expected", [
    ("dephased", "cpu", 1024 * 8 * 9),
    ("coherent", "cpu", 1024 * 8 * 4),
    ("coherent", "cuda", 1024 * 8 * 4),
    ("dephased", "cuda", 3 * 8),
])
def test_a_chunk_is_sized_by_what_it_stages(method, device, expected):
    # 800 segments pad to 1024 leaves; the kernel stages none
    assert lk.staged_bytes_per_speed(method, 800, device) == expected


def test_the_kernel_span_is_a_program_span():
    assert "lz.dephase.kernel" in profiling.SPANS
    assert profiling.SPANS.index("lz.dephase") < profiling.SPANS.index("lz.dephase.kernel")
