"""A hardened content-addressed store for sweep chunk results.

Counterpart of ``bdlz_tpu/provenance/store.py``; the on-disk layout is
the same (``<root>/<kind>/<key>.npz``), so one root can be shared with
the JAX package — the chunk keys themselves never collide, because the
port's carry its own ``platform``.

* The root is created ``0700`` and trusted only if it is a real
  directory (a symlink is refused), owned by this user and not group- or
  other-writable (:class:`StoreUntrustedError`).
* Every write is a temp file in the final directory, fsynced, then
  ``os.replace``: readers see the old entry or the new one.
* A corrupt entry is deleted and reported as a miss: one recompute.
* Stale ``*.tmp*`` files of dead writers are evicted by age.
"""
from __future__ import annotations

import json
import os
import stat as statmod
import sys
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np

_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-"
)


class StoreUntrustedError(RuntimeError):
    """The store root cannot be trusted (symlink, foreign owner, loose
    permissions, not a directory)."""


class StoreStats:
    """Per-instance hit, miss, write and eviction counters."""

    def __init__(self) -> None:
        self.hits = 0
        self.misses = 0
        self.writes = 0
        self.dropped_corrupt = 0

    def as_dict(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "writes": self.writes,
            "dropped_corrupt": self.dropped_corrupt,
        }


class Store:
    """A flat or one-level content-addressed file store."""

    def __init__(self, root: str):
        root = os.path.abspath(os.path.expanduser(str(root)))
        os.makedirs(root, mode=0o700, exist_ok=True)
        st = os.lstat(root)
        if statmod.S_ISLNK(st.st_mode):
            raise StoreUntrustedError(f"{root} is a symlink")
        if not statmod.S_ISDIR(st.st_mode):
            raise StoreUntrustedError(f"{root} is not a directory")
        if st.st_uid != os.getuid():
            raise StoreUntrustedError(f"{root} is owned by uid {st.st_uid}, not {os.getuid()}")
        if st.st_mode & 0o022:
            raise StoreUntrustedError(
                f"{root} is group/other-writable (mode {statmod.S_IMODE(st.st_mode):04o})"
            )
        self.root = root
        self.stats = StoreStats()
        self._faults = None
        self._reads = 0

    def arm_faults(self, plan) -> None:
        """Arm a fault plan on the read side: ``get_npz``/``get_array``
        fire ``store_read`` specs keyed by a per-store read counter just
        before loading.  ``None`` disarms."""
        self._faults = plan
        self._reads = 0

    def _read_fault(self, path: str) -> None:
        if self._faults is None:
            return
        key = self._reads
        self._reads += 1
        self._faults.corrupt_file("store_read", key, path)
        self._faults.corrupt_bytes("store_read", key, path)

    def path_for(self, name: str) -> str:
        """Absolute path of entry ``name`` (``[kind/]filename``); creates
        the kind directory (0700) on demand."""
        parts = str(name).split("/")
        if (
            not 1 <= len(parts) <= 2
            or any(not p or p.startswith(".") for p in parts)
            or any(set(p) - _NAME_OK for p in parts)
        ):
            raise ValueError(
                f"invalid store entry name {name!r}: expected "
                "'[kind/]filename' from [A-Za-z0-9._-], no leading dots"
            )
        if len(parts) == 2:
            os.makedirs(os.path.join(self.root, parts[0]), mode=0o700, exist_ok=True)
        return os.path.join(self.root, *parts)

    def has(self, name: str) -> bool:
        """Existence probe, without a read and without counting."""
        return os.path.exists(self.path_for(name))

    def _drop_corrupt(self, path: str, exc: Exception) -> None:
        print(f"[store] {path} is corrupt ({exc!r}); deleting and recomputing",
              file=sys.stderr)
        self.stats.dropped_corrupt += 1
        try:
            os.remove(path)
        except OSError:
            pass

    def _get(self, name: str, load):
        path = self.path_for(name)
        if not os.path.exists(path):
            self.stats.misses += 1
            return None
        self._read_fault(path)
        try:
            out = load(path)
        except Exception as exc:  # noqa: BLE001 — a corrupt entry is a miss
            self._drop_corrupt(path, exc)
            self.stats.misses += 1
            return None
        self.stats.hits += 1
        return out

    def get_array(self, name: str) -> Optional[np.ndarray]:
        return self._get(name, np.load)

    def put_array(self, name: str, arr: np.ndarray) -> str:
        from bdlz_tpu_torch.utils.io import atomic_save_npy

        path = self.path_for(name)
        atomic_save_npy(path, np.asarray(arr), durable=True)
        self.stats.writes += 1
        return path

    def get_npz(self, name: str) -> Optional[Dict[str, np.ndarray]]:
        """Every array of an ``.npz`` entry, loaded into host memory."""
        def load(path):
            with np.load(path) as data:
                return {k: np.asarray(data[k]) for k in data.files}
        return self._get(name, load)

    def put_npz(self, name: str, arrays: Mapping[str, np.ndarray]) -> str:
        from bdlz_tpu_torch.utils.io import atomic_savez

        path = self.path_for(name)
        atomic_savez(path, durable=True, **dict(arrays))
        self.stats.writes += 1
        return path

    def get_json(self, name: str) -> Optional[Any]:
        path = self.path_for(name)
        if not os.path.exists(path):
            self.stats.misses += 1
            return None
        try:
            with open(path, encoding="utf-8") as f:
                out = json.load(f)
        except Exception as exc:  # noqa: BLE001 — a corrupt entry is a miss
            self._drop_corrupt(path, exc)
            self.stats.misses += 1
            return None
        self.stats.hits += 1
        return out

    def put_json(self, name: str, payload: Any) -> str:
        from bdlz_tpu_torch.utils.io import atomic_write_json

        path = self.path_for(name)
        atomic_write_json(path, payload, durable=True)
        self.stats.writes += 1
        return path

    def evict_partials(self, max_age_s: float = 3600.0) -> int:
        """Remove ``*.tmp*`` files and directories older than
        ``max_age_s`` (younger ones may belong to a live writer).
        Returns the number evicted."""
        import shutil

        now = time.time()
        evicted = 0
        for dirpath, dirnames, filenames in os.walk(self.root):
            for dn in list(dirnames):
                if ".tmp" not in dn:
                    continue
                path = os.path.join(dirpath, dn)
                try:
                    if now - os.lstat(path).st_mtime >= max_age_s:
                        shutil.rmtree(path, ignore_errors=True)
                        evicted += 1
                        dirnames.remove(dn)
                except OSError:
                    pass
            for fn in filenames:
                if ".tmp" not in fn:
                    continue
                path = os.path.join(dirpath, fn)
                try:
                    if now - os.lstat(path).st_mtime >= max_age_s:
                        os.remove(path)
                        evicted += 1
                except OSError:
                    pass
        return evicted


def default_store_root() -> str:
    """``$XDG_CACHE_HOME`` (or ``~/.cache``) + ``bdlz_store``."""
    cache_root = os.environ.get(
        "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache")
    )
    return os.path.join(cache_root, "bdlz_store")


def resolve_store(cache=None, base=None, label: str = "cache") -> Optional[Store]:
    """The result-cache tri-state: explicit :class:`Store` ▸ explicit
    root ▸ ``Config.cache_root`` ▸ ``BDLZ_CACHE_ROOT``.
    ``Config.cache_enabled`` False forces caching off, True turns it on
    at :func:`default_store_root` when no root is set, None (the default)
    caches exactly when a root is set.  An untrusted root disables
    caching, loudly."""
    enabled = getattr(base, "cache_enabled", None) if base is not None else None
    if enabled is False:
        return None
    if isinstance(cache, Store):
        return cache
    root = cache if isinstance(cache, str) and cache else None
    if root is None and base is not None:
        root = getattr(base, "cache_root", None) or None
    if root is None:
        root = os.environ.get("BDLZ_CACHE_ROOT") or None
    if root is None:
        if enabled is not True:
            return None
        root = default_store_root()
    try:
        return Store(root)
    except StoreUntrustedError as exc:
        print(f"[{label}] {exc}; caching disabled", file=sys.stderr)
        return None
