"""Worker of the port's two-process whole-host failover test
(``tests/test_torch_fabric.py``), run as
``python _mp_torch_fabric_worker.py <role> <store_root> <content_hash>
[<cache_root>]`` on the CPU, both roles sharing one store root (the
membership records and the artifact registry):

* the **victim** registers fabric seat 0 on a 2 s wall-clock lease,
  cold-admits the tenant, answers a fixed trace, prints the values and
  exits without standing down: its lease dangles until TTL expiry;
* the **survivor** registers seat 1, heartbeats until the router's live
  set no longer holds the victim (TTL arithmetic alone), then serves the
  same trace: the router must pick it, its cold admission must be one
  fetch through its pull-through cache, and the values must be the
  victim's, bit for bit.

Prints one JSON line; any broken contract is a traceback and a non-zero
exit.  Imports nothing of JAX.
"""
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

FABRIC = "mpfab"
SCENARIO = "coherent"


def _base():
    from bdlz_tpu_torch.config import config_from_dict

    return config_from_dict({
        "regime": "nonthermal",
        "P_chi_to_B": 0.14925839040304145,
        "source_shape_sigma_y": 9.0,
        "incident_flux_scale": 1.07e-9,
        "Y_chi_init": 4.90e-10,
    })


def _thetas():
    import numpy as np

    rng = np.random.default_rng(5)
    return np.column_stack([rng.uniform(0.92, 1.08, 4), rng.uniform(92.0, 108.0, 4),
                            rng.uniform(0.26, 0.34, 4)])


def _host(store, content_hash, role, index, ttl_s, cache_root=None):
    from bdlz_tpu_torch.serve import FabricHost

    return FabricHost(_base(), fabric=FABRIC, host_id=role, host_index=index, store=store,
                      tenant_map={SCENARIO: content_hash}, ttl_s=ttl_s,
                      cache_root=cache_root, max_batch_size=4, devices=["cpu"])


def _serve_trace(host):
    futs = [host.submit(t, scenario=SCENARIO) for t in _thetas()]
    host.drain()
    out = [f.result(timeout=0) for f in futs]
    assert all(r.host_id == host.host_id and not r.degraded for r in out)
    return [r.value for r in out]


def victim(store, content_hash):
    host = _host(store, content_hash, "victim", 0, ttl_s=2.0)
    host.register()
    print(json.dumps({"values": _serve_trace(host)}))
    sys.stdout.flush()
    os._exit(0)  # host death: no close, no lease release


def survivor(store, content_hash, cache_root):
    from bdlz_tpu_torch.serve import GlobalRouter

    host = _host(store, content_hash, "survivor", 1, ttl_s=30.0, cache_root=cache_root)
    router = GlobalRouter(store, FABRIC, 2)
    host.register()
    deadline = time.time() + 60.0
    while time.time() < deadline:
        host.heartbeat()
        if "victim" not in {r["host_id"] for r in router.live()}:
            break
        time.sleep(0.1)
    else:
        raise AssertionError("the victim's lease never expired")
    routed = router.route(scenario=SCENARIO)
    assert routed["host_id"] == "survivor", routed
    values = _serve_trace(host)
    print(json.dumps({"values": values, "admissions": len(host.service.admission_events),
                      "cache": host.artifact_cache.counters()}))
    sys.stdout.flush()
    host.close()


def main():
    from bdlz_tpu_torch.provenance import Store

    role, store_root, content_hash = sys.argv[1:4]
    store = Store(store_root)
    if role == "victim":
        victim(store, content_hash)
    elif role == "survivor":
        survivor(store, content_hash, sys.argv[4])
    else:
        raise SystemExit(f"unknown role {role!r}")


if __name__ == "__main__":
    main()
