"""The kernel engine's chunk step as a CUDA graph (``ops/kjma_kernel``'s
``graph_route``, ``graph_key``, ``chunk_graph``), on the CPU: what decides
the route and what keys the cache, without launching anything.

* The route: eager on the CPU, under NaN debugging and for an empty
  chunk; the graph on one CUDA device, decided from its description
  alone.  A mesh sweep's members never ask for a graph.
* The key changes with the device, the chunk's length, the node count,
  the tier, the ``StaticChoices`` fields the step reads, the table's
  scalars and length, the stream and the thread; the sweep hands the
  step a chunk's length only, never its values.
* ``chunk_graph`` runs a key's first chunk eagerly and builds
  nothing, then keeps one graph per key, the most recent
  ``GRAPH_CACHE_SIZE`` of them (the graph and the card stood in for).
* A launch made while a graph captures is recorded by the capture, which
  holds exactly one of its tier's kernel, and counted in ``LAUNCHES`` at
  each replay (the capture and the card stood in for).
* A CPU sweep of the kernel engine runs every chunk eagerly and counts
  it so; the other engines never reach the route.

The replayed graph itself runs only on the card:
``tests/test_torch_kernels_gpu.py`` holds it bit for bit to the eager step.
"""
import types

import numpy as np
import pytest
import torch

from bdlz_tpu_torch import config as tc
from bdlz_tpu_torch.ops import kjma_kernel as kk
from bdlz_tpu_torch.ops.kjma_table import make_f_table
from bdlz_tpu_torch.parallel import make_mesh
from bdlz_tpu_torch.parallel import sweep as ts
from bdlz_tpu_torch.utils import profiling

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
AXES = {"m_chi_GeV": np.geomspace(0.3, 3.0, 8), "T_p_GeV": np.geomspace(50.0, 200.0, 8)}
KW = dict(chunk_size=16, n_y=400, table_nodes=512, device="cpu")
CUDA0 = torch.device("cuda", 0)


def _static(**kw):
    return tc.static_choices_from_config(tc.config_from_dict(ARCHIVED))._replace(
        **{"quad_panel_gl": False, **kw})


@pytest.fixture(scope="module")
def table():
    return make_f_table(1.0, n=512)


@pytest.fixture
def nan_debugging():
    profiling.enable_nan_debugging(True)
    try:
        yield
    finally:
        profiling.enable_nan_debugging(False)


@pytest.mark.parametrize("device,n_points,want", [
    ("cpu", 8192, False),
    (CUDA0, 0, False),
    (CUDA0, 8192, True),
    (torch.device("cuda", 1), 16, True),
], ids=["cpu", "empty", "one_card", "second_card"])
def test_the_graph_runs_on_one_card_for_a_non_empty_chunk(device, n_points, want):
    assert kk.graph_route(device, n_points) is want


def test_a_mesh_sweep_never_asks_for_a_graph(monkeypatch):
    """The mesh's members run the eager step on streams of their own:
    the mesh step never reaches ``chunk_graph``."""
    def refuse(*args):
        raise AssertionError("a mesh member asked for a graph")

    monkeypatch.setattr(kk, "chunk_graph", refuse)
    kk.reset_graph_stats()
    res = ts.run_sweep(tc.config_from_dict(ARCHIVED), AXES, _static(), impl="kernel",
                       mesh=make_mesh((2, 1), devices=["cpu", "cpu"]), **KW)
    assert res.n_failed == 0 and kk.GRAPH_STATS["replays"] == 0


def test_nan_debugging_keeps_the_eager_step(nan_debugging):
    assert not kk.graph_route(CUDA0, 8192)


def _key(table, **change):
    args = dict(device=CUDA0, n_points=8192, n_y=8000, fuse_exp=False, reduce=True,
                static=_static(), table=table, stream=7, thread=1)
    args.update(change)
    return kk.graph_key(**args)


@pytest.mark.parametrize("change", [
    dict(device=torch.device("cuda", 1)),
    dict(n_points=8190),
    dict(n_y=4000),
    dict(fuse_exp=True),
    dict(reduce=False),
    dict(static=_static(chi_stats="boson")),
    dict(static=_static(regime="thermal")),
    dict(stream=8),
    dict(thread=2),
], ids=["device", "P", "n_y", "fuse_exp", "reduce", "chi_stats", "regime", "stream",
        "thread"])
def test_the_key_changes_with_what_the_capture_bakes_in(change, table):
    assert _key(table, **change) != _key(table)


@pytest.mark.parametrize("field", ["I_p", "y0", "inv_dy", "length"])
def test_the_key_changes_with_the_table_s_scalars_and_length(field, table):
    if field == "length":
        other = table._replace(values=np.zeros(len(table.values) + 1))
    else:
        other = table._replace(**{field: getattr(table, field) * (1.0 + 1e-15) + 1e-300})
    assert _key(other) != _key(table)


def test_the_key_ignores_what_the_capture_does_not_read(table):
    # fields the kernel step does not read, the node count's floor, and
    # a fresh table tensor of the same scalars
    assert _key(table, static=_static(ode_rtol=1e-6, quad_panel_gl=None)) == _key(table)
    assert _key(table, n_y=400) == _key(table, n_y=kk.N_Y_FLOOR)
    assert _key(table._replace(values=table.values.copy())) == _key(table)


def test_the_sweep_asks_for_a_graph_by_the_chunk_s_length_only(table, monkeypatch):
    """The kernel engine's step asks the graph cache, recording here what
    it asks for."""
    base = tc.config_from_dict(ARCHIVED)
    pp = ts.build_grid(base, AXES)
    asked, real = [], kk.chunk_graph

    def recording(n_points, device, tab, *tier):
        asked.append((n_points, str(device), tab))
        return real(n_points, device, tab, *tier)

    monkeypatch.setattr(kk, "chunk_graph", recording)
    engine = ts.build_chunk_engine(None, _static(), n_y=400, impl="kernel", device="cpu",
                                   table_np=table)
    outs = [ts.evaluate_chunk(engine, ts._pad_chunk(pp, lo, lo + 16, 16), 16)
            for lo in (0, 16)]
    assert not np.array_equal(outs[0]["DM_over_B"], outs[1]["DM_over_B"])
    assert [a[:2] for a in asked] == [(16, "cpu")] * 2
    assert asked[0][2] is asked[1][2] is engine[1]


class _StandIn:
    """A graph made without a card: records what it was made for."""

    def __init__(self, device, n_points, n_y, static, table, fuse_exp, reduce):
        self.made_for = (device, n_points)


@pytest.fixture
def stand_in_card(monkeypatch):
    """``chunk_graph`` on a stood-in card: ``_StandIn`` graphs, one
    stream; a table said to be on cuda:0."""
    monkeypatch.setattr(kk, "ChunkGraph", _StandIn)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=5))
    kk.clear_graphs()
    values = types.SimpleNamespace(device=CUDA0, shape=(512,))
    try:
        yield kk.KJMATable(y0=-40.0, inv_dy=6.0, values=values, I_p=1.0)
    finally:
        kk.clear_graphs()


def _graph_of(n_y=8000):
    """The graph lookup of the kernel engine's P1 tier at ``n_y``."""
    def graph(n_points, device, table):
        return kk.chunk_graph(n_points, device, table, _static(), n_y, False, True)
    return graph


def _seen(graph, n_points, tab):
    """Ask for the graph of ``n_points`` twice: the first time builds
    nothing, the second captures."""
    assert graph(n_points, CUDA0, tab) is None
    return graph(n_points, CUDA0, tab)


def test_one_graph_per_key_and_the_most_recent_kept(stand_in_card, monkeypatch):
    monkeypatch.setattr(kk, "GRAPH_CACHE_SIZE", 3)
    tab = stand_in_card
    graph = _graph_of()
    first = _seen(graph, 8192, tab)
    assert first.made_for == (CUDA0, 8192)
    assert graph(8192, "cuda:0", tab) is first
    others = [_seen(graph, n, tab) for n in (16, 32)]
    assert len(kk._GRAPHS) == 3 and len({id(g) for g in others + [first]}) == 3
    assert graph(8192, CUDA0, tab) is first      # now the most recent
    _seen(graph, 64, tab)                        # evicts the graph of 16
    assert len(kk._GRAPHS) == 3
    assert graph(32, CUDA0, tab) is others[1]
    assert graph(16, CUDA0, tab) is None         # seen anew: eager once more
    assert graph(16, CUDA0, tab) is not others[0]
    # a table on another device stays on the eager step, which refuses it
    assert graph(8192, CUDA0, tab._replace(values=torch.zeros(512))) is None


def test_a_key_seen_once_builds_nothing(stand_in_card, monkeypatch):
    """Shapes used once (an emulator round's chunk, a gate's population)
    run eagerly and never capture; the keys seen once are bounded."""
    monkeypatch.setattr(kk, "SEEN_KEYS", 4)
    tab = stand_in_card
    graph = _graph_of()
    assert [graph(n, CUDA0, tab) for n in range(1, 11)] == [None] * 10
    assert not kk._GRAPHS and len(kk._SEEN) == 4
    assert graph(3, CUDA0, tab) is None          # forgotten: seen anew
    assert graph(10, CUDA0, tab).made_for == (CUDA0, 10)
    assert list(kk._GRAPHS) and 10 not in [k[2] for k in kk._SEEN]


class _FakeCapture:
    """``torch.cuda.graph`` and ``CUDAGraph`` without a card: a capture
    that records the stream it was given; a graph that counts replays."""

    def __init__(self):
        self.streams, self.replays, self.capturing = [], 0, False

    def graph(self, graph, stream=None, capture_error_mode="global"):
        import contextlib

        self.streams.append(stream)

        @contextlib.contextmanager
        def capture():
            self.capturing = True
            try:
                yield
            finally:
                self.capturing = False
        return capture()

    def CUDAGraph(self):
        fake = self

        class _Graph:
            def replay(self):
                fake.replays += 1
        return _Graph()


@pytest.fixture
def fake_capture(monkeypatch, table):
    """A ``ChunkGraph`` of the P1 tier on the CPU whose step launches
    what the test sets in ``launch`` through ``_launched``."""
    import contextlib

    fake = _FakeCapture()
    monkeypatch.setattr(torch.cuda, "graph", fake.graph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", fake.CUDAGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: ("stream", str(device)))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    cpu_table = table._replace(values=torch.as_tensor(table.values))
    g = kk.ChunkGraph("cpu", 16, 400, _static(), cpu_table, False, True)
    fake.launch = ["point_reduce"]

    def compute():
        for name in fake.launch:  # a name, or (name, False) for a launch off the capture
            name, on_capture = (name, True) if isinstance(name, str) else name
            kk._launched(name, "kjma_" + name, 0, None, torch.zeros(1),
                         fake.capturing and on_capture)
    monkeypatch.setattr(g, "_compute", compute)
    kk.reset_launches()
    kk.reset_graph_stats()
    yield g, cpu_table, fake
    # the counters are the process's: leave none of this test's counts behind
    kk.reset_launches()
    kk.reset_graph_stats()


def test_each_replay_counts_the_launches_its_capture_recorded(fake_capture):
    g, tab, fake = fake_capture
    out = [g.run(tab) for _ in range(3)]
    assert all(o is g.out for o in out) and fake.replays == 3
    assert kk.GRAPH_STATS == {"captures": 1, "replays": 3, "eager": 0}
    assert kk.LAUNCHES == {k: 3 if k == "point_reduce" else 0 for k in kk.LAUNCHES}
    # the capture ran on a stream of the graph's own device
    assert fake.streams == [("stream", "cpu")]


@pytest.mark.parametrize("launch", [
    [], ["point_reduce"] * 2, ["point_stream"], [("point_reduce", False)],
], ids=["none", "twice", "another_tier", "off_the_capturing_stream"])
def test_a_capture_without_one_launch_of_its_tier_s_kernel_is_refused(fake_capture, launch):
    """A kernel launched on a stream that was not capturing (say, another
    device's) ran once, eagerly, and is counted so; the graph would replay
    without it, so the capture is refused."""
    g, tab, fake = fake_capture
    fake.launch = launch
    with pytest.raises(RuntimeError, match="not one launch of point_reduce"):
        g.run(tab)
    assert fake.replays == 0 and kk.GRAPH_STATS["captures"] == 0
    eager = sum(1 for x in launch if not isinstance(x, str))
    assert kk.LAUNCHES == {k: eager if k == "point_reduce" else 0 for k in kk.LAUNCHES}


def test_a_launch_into_another_capture_is_refused():
    with pytest.raises(RuntimeError, match="not a chunk graph's"):
        kk._launched("point_reduce", "kjma_point_reduce", 0, None, torch.zeros(1), True)


@pytest.mark.parametrize("impl", ["kernel", "tabulated"])
def test_a_cpu_sweep_runs_its_chunks_eagerly(impl):
    kk.reset_graph_stats()
    res = ts.run_sweep(tc.config_from_dict(ARCHIVED), AXES, _static(), impl=impl, **KW)
    assert res.chunks == 4 and res.n_failed == 0
    want = {"captures": 0, "replays": 0, "eager": 4 if impl == "kernel" else 0}
    assert kk.GRAPH_STATS == want
    assert _graph_of(400)(16, "cpu", None) is None


def test_the_kernel_step_names_its_tier_s_kernel():
    assert [kk.tier_kernel(f, r) for f in (False, True) for r in (True, False)] == [
        "point_reduce", "point_stream", "point_fused_reduce", "point_fused_stream"]
    assert set(kk.LAUNCHES) == {kk.tier_kernel(f, r) for f in (False, True)
                                for r in (True, False)}
    assert "chunk.replay" in profiling.SPANS
