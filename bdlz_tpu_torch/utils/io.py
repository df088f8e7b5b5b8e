"""Output layer: the ``yields_out.json`` artifact and atomic JSON, text
and array writes.

Counterpart of ``bdlz_tpu/utils/io.py``: ``atomic_write_json``,
``atomic_write_text``, ``atomic_savez``, ``atomic_save_npy``,
``yields_out_payload`` and ``write_yields_out``.  The schema is the
reference contract: ``{"inputs": {<20 reference keys in declaration
order>, "P_used": P, <extension keys that differ from their defaults>},
"final": {Y_B, Y_chi, rho_B_kg_m3, rho_DM_kg_m3, DM_over_B}}``.  Results
may be one-element tensors on any device; they are written as Python
floats.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict

from bdlz_tpu_torch.config import REFERENCE_KEYS, Config, default_config


def _fsync_dir(path: str) -> None:
    """fsync a directory so that a rename into it survives a host crash
    (best effort: some filesystems refuse to open a directory)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(
    path: str, payload: Any, durable: bool = False, **dump_kwargs: Any
) -> None:
    """Write ``payload`` as JSON to ``path`` atomically: a temp file in the
    destination directory, then ``os.replace``, so a reader sees the old
    file or the new one, never half a write.  ``durable`` also fsyncs the
    file before the rename and the directory after it."""
    _atomic_write(path, lambda f: json.dump(payload, f, **dump_kwargs), durable)


def atomic_write_text(path: str, text: str, durable: bool = False) -> None:
    """Write ``text`` to ``path`` atomically, as :func:`atomic_write_json`
    does (profile CSVs derived from a bounce, ``lz/profile.py``)."""
    _atomic_write(path, lambda f: f.write(text), durable)


def atomic_savez(path: str, durable: bool = False, **arrays: Any) -> None:
    """``np.savez`` made atomic as :func:`atomic_write_json` is: sweep
    chunk files, emulator tables and store entries.  The temp name ends
    in ``.npz``, or ``np.savez`` would append the suffix and the rename
    would miss."""
    import numpy as np

    if not path.endswith(".npz"):
        path += ".npz"
    _atomic_write(path, lambda f: np.savez(f, **arrays), durable,
                  suffix=".tmp.npz", mode="wb")


def atomic_save_npy(path: str, arr: Any, durable: bool = False) -> None:
    """``np.save`` made atomic; writing through the open file keeps
    ``np.save`` from appending ``.npy``, so the target is exactly
    ``path``."""
    import numpy as np

    _atomic_write(path, lambda f: np.save(f, arr), durable,
                  suffix=".tmp.npy", mode="wb")


def _atomic_write(path: str, write, durable: bool, suffix: str = ".tmp",
                  mode: str = "w") -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=suffix)
    try:
        with os.fdopen(fd, mode, **({"encoding": "utf-8"} if mode == "w" else {})) as f:
            write(f)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if durable:
            _fsync_dir(d)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _scalar(v: Any) -> Any:
    """A NumPy scalar or a one-element tensor as a plain Python number."""
    if hasattr(v, "item"):
        return v.item()
    return v


def yields_out_payload(cfg: Config, P_used: float, result) -> Dict[str, Any]:
    """The ``yields_out.json`` payload for one point (``result`` is a
    ``YieldsResult`` of scalars or one-element tensors)."""
    inputs: Dict[str, Any] = {k: getattr(cfg, k) for k in REFERENCE_KEYS}
    inputs["P_used"] = _scalar(P_used)
    defaults = default_config()
    for key in defaults:
        if key not in REFERENCE_KEYS and getattr(cfg, key) != defaults[key]:
            inputs[key] = getattr(cfg, key)
    return {
        "inputs": inputs,
        "final": {
            "Y_B": _scalar(result.Y_B),
            "Y_chi": _scalar(result.Y_chi),
            "rho_B_kg_m3": _scalar(result.rho_B_kg_m3),
            "rho_DM_kg_m3": _scalar(result.rho_DM_kg_m3),
            "DM_over_B": _scalar(result.DM_over_B),
        },
    }


def write_yields_out(path: str, cfg: Config, P_used: float, result) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(yields_out_payload(cfg, P_used, result), f, indent=2)
