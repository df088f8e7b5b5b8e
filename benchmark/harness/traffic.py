"""The one traffic generator: a mix file's parameters and a seed in, requests out.

A mix (``benchmark/traffic/<name>.json``) names its sweep axes in the
CLI's syntax (``geom:a:b:n`` or ``lin:a:b:n``), the jitter of the axes'
endpoints, the ``run_sweep`` keyword arguments of every request
(``engine``, laid over the configuration's ``sweep``), optional
``static`` choices (``StaticChoices`` fields, as the CLI's ``--quad``
sets one), optional ``draw`` ranges, each a keyword argument or a key
inside one (``"bounce.lam4": [lo, hi]``) drawn uniformly per request, how
many of a request's points the check compares, and how many requests the
traced run profiles.  Request ``k`` of seed ``s`` is drawn from its own
stream, so the same seed gives the same requests and every seed the same
sizes.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, NamedTuple

import numpy as np

#: Stream tags: the set-up's warm request, the window's requests, and the
#: points each request's check samples.
WARM, WINDOW, SAMPLE = 0, 1, 2


class Request(NamedTuple):
    index: int
    axes: Dict[str, np.ndarray]
    kwargs: Dict[str, Any]       # run_sweep's keyword arguments
    n_points: int


def parse_axis(spec: str):
    """``geom:a:b:n`` / ``lin:a:b:n`` as (kind, a, b, n)."""
    kind, a, b, n = spec.split(":")
    if kind not in ("geom", "lin"):
        raise ValueError(f"axis kind must be geom or lin, got {spec!r}")
    return kind, float(a), float(b), int(n)


def axis_values(kind: str, a: float, b: float, n: int) -> np.ndarray:
    return np.geomspace(a, b, n) if kind == "geom" else np.linspace(a, b, n)


def rng(seed: int, tag: int, index: int) -> np.random.Generator:
    # SeedSequence takes non-negative integers of any size
    return np.random.default_rng([int(seed) % (1 << 64), tag, index])


def make_request(traffic: Mapping, config: Mapping, seed: int, index: int,
                 tag: int = WINDOW) -> Request:
    """Request ``index``: each axis endpoint scaled by a factor drawn
    uniformly from [1 - jitter, 1 + jitter], the sizes fixed; then each
    of the mix's ``draw`` ranges drawn uniformly into the keyword
    arguments (a dotted name sets a key inside one)."""
    r = rng(seed, tag, index)
    j = float(traffic["jitter"])
    axes = {}
    for name, spec in traffic["axes"].items():
        kind, a, b, n = parse_axis(spec)
        a *= r.uniform(1.0 - j, 1.0 + j)
        b *= r.uniform(1.0 - j, 1.0 + j)
        axes[name] = axis_values(kind, a, b, n)
    kwargs = copy.deepcopy({**config["sweep"], **traffic["engine"]})
    for path, (lo, hi) in traffic.get("draw", {}).items():
        *outer, key = path.split(".")
        into = kwargs
        for part in outer:
            into = into[part]
        into[key] = float(r.uniform(lo, hi))
    n = int(np.prod([len(v) for v in axes.values()]))
    return Request(index, axes, kwargs, n)


def sample_points(traffic: Mapping, seed: int, request: Request) -> np.ndarray:
    """The points of ``request`` that the check compares: the first and
    the last grid point (the axes' extreme corners) and a uniform draw."""
    n = request.n_points
    k = min(int(traffic["check"]["points_per_sweep"]), n)
    drawn = rng(seed, SAMPLE, request.index).choice(n, size=k, replace=False)
    return np.unique(np.concatenate([[0, n - 1], drawn]))
