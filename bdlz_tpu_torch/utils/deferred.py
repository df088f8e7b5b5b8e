"""Flags of the JAX package's command lines that the port does not have
yet.  Each is registered, so that passing it is an ``argparse`` error that
names the ROADMAP item bringing it: a flag is never accepted and then
ignored."""
from __future__ import annotations

from typing import Mapping, Tuple

#: flag → (takes a value, where it stands in ROADMAP.md)
DeferredFlags = Mapping[str, Tuple[bool, str]]


def _dest(flag: str) -> str:
    return "deferred_" + flag.lstrip("-").replace("-", "_")


def add_deferred_flags(ap, flags: DeferredFlags) -> None:
    group = ap.add_argument_group("not ported yet (each one is refused)")
    for flag, (takes_value, item) in flags.items():
        kw = (dict(default=None, metavar="VALUE") if takes_value
              else dict(action="store_const", const=True, default=None))
        group.add_argument(flag, dest=_dest(flag), help=f"not ported yet: {item}", **kw)


def refuse_deferred_flags(ap, args, flags: DeferredFlags) -> None:
    for flag, (_, item) in flags.items():
        if getattr(args, _dest(flag)) is not None:
            ap.error(f"{flag} is not ported to bdlz_tpu_torch yet ({item})")
