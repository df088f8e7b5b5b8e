"""Worker of the port's two-process tests (``tests/test_torch_multihost.py``),
run as ``python _mp_torch_mesh_worker.py <mode> <port> <process_id> <out_dir>``
on the CPU.  Both processes join one ``gloo`` process group over
localhost (2 processes × 2 CPU members = a 4-member mesh) and run one
case, mirroring the JAX package's two-process workers:

* ``sweep`` — the mesh-split sweep into a resume directory, then a resume
  pass that must skip every chunk on both processes;
* ``faults`` — a transient error on chunk 0 and a poison point, healed to
  the same quarantine on both processes, then resumed;
* ``mcmc`` — a checkpointed stretch chain over the mesh (coordinator-only
  writes), then a resume pass that reproduces it bitwise;
* ``knob`` — process 1 reports another kernel library digest: the
  sweep's startup agreement must raise on both processes;
* ``cache`` — a cold sweep fills a shared store (coordinator-only writes),
  a warm one serves every chunk from the broadcast hit plan;
* ``rollout`` — the cutover agreement with an equal hash, a differing
  hash and a cold stage: both processes return or raise together.

Prints ``worker <pid> OK`` (and the mode's JSON); a broken contract is a
traceback and a non-zero exit.  Imports nothing of JAX.
"""
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

BASE = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}


def _cfg():
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config

    cfg = config_from_dict(dict(BASE))
    return cfg, static_choices_from_config(cfg)


def _axes():
    import numpy as np

    return {"m_chi_GeV": np.geomspace(0.3, 3.0, 8).tolist()}


def _mesh():
    from bdlz_tpu_torch.parallel import make_mesh

    return make_mesh(shape=(4, 1), devices=["cpu", "cpu"])


def sweep(pid, out):
    import numpy as np

    from bdlz_tpu_torch.parallel import run_sweep

    cfg, static = _cfg()
    kw = dict(mesh=_mesh(), chunk_size=4, n_y=2000, out_dir=f"{out}/sweep")
    res = run_sweep(cfg, _axes(), static, **kw)
    assert res.n_failed == 0 and not res.failed_mask.any()
    res2 = run_sweep(cfg, _axes(), static, **kw)
    assert res2.resumed_chunks == res.chunks, (res2.resumed_chunks, res.chunks)
    np.testing.assert_array_equal(res.outputs["DM_over_B"], res2.outputs["DM_over_B"])
    np.savez(f"{out}/result_p{pid}.npz", **res.outputs)


def faults(pid, out):
    import numpy as np

    from bdlz_tpu_torch.faults import FaultPlan
    from bdlz_tpu_torch.parallel import run_sweep
    from bdlz_tpu_torch.utils.retry import RetryPolicy

    cfg, static = _cfg()

    def plan():
        return FaultPlan.from_obj([
            {"site": "step", "kind": "transient", "key": 0, "times": 1},
            {"site": "step", "kind": "poison", "point": 5},
        ])

    retry = RetryPolicy(max_attempts=2, backoff_s=0.0, sleep=lambda s: None)
    kw = dict(mesh=_mesh(), chunk_size=4, n_y=2000, out_dir=f"{out}/sweep", retry=retry)
    res = run_sweep(cfg, _axes(), static, fault_plan=plan(), **kw)
    expected = np.zeros(8, dtype=bool)
    expected[5] = True
    assert res.n_quarantined == 1 and res.n_failed == 1 and res.n_retries >= 1, res
    np.testing.assert_array_equal(res.quarantined_mask, expected)
    np.testing.assert_array_equal(res.failed_mask, expected)
    res2 = run_sweep(cfg, _axes(), static, fault_plan=plan(), **kw)
    assert res2.resumed_chunks == res.chunks and res2.n_quarantined == 1
    assert res2.n_retries == 0
    np.testing.assert_array_equal(res2.quarantined_mask, expected)
    np.testing.assert_array_equal(res.outputs["DM_over_B"], res2.outputs["DM_over_B"])
    np.savez(f"{out}/faults_p{pid}.npz", DM_over_B=res.outputs["DM_over_B"],
             quarantined=res.quarantined_mask, failed=res.failed_mask,
             n_retries=res.n_retries)


def mcmc_logp():
    """(W, 2) -> (W,): a correlated Gaussian, cheap but real."""
    def logp(theta):
        return -0.5 * (theta[:, 0] ** 2 + 2.0 * (theta[:, 1] - theta[:, 0]) ** 2)

    logp.device = "cpu"
    return logp


def mcmc_init():
    import numpy as np

    return np.random.default_rng(7).uniform(-1.0, 1.0, (16, 2))


def mcmc(pid, out):
    import numpy as np

    from bdlz_tpu_torch.sampling.checkpoint import run_ensemble_checkpointed

    kw = dict(seed=3, logp_fn=mcmc_logp(), init_walkers=mcmc_init(), n_steps=24,
              out_dir=f"{out}/chain", checkpoint_every=8, mesh=_mesh(),
              identity={"toy": "gaussian-v1"})
    run = run_ensemble_checkpointed(**kw)
    assert run.segments == 3 and run.resumed_segments == 0
    assert run.chain.shape == (24, 16, 2), run.chain.shape
    run2 = run_ensemble_checkpointed(**kw)
    assert run2.resumed_segments == 3, run2.resumed_segments
    np.testing.assert_array_equal(run.chain, run2.chain)
    np.testing.assert_array_equal(run.logp_chain, run2.logp_chain)
    np.savez(f"{out}/mcmc_p{pid}.npz", chain=run.chain, logp=run.logp_chain)


def knob(pid, out):
    from bdlz_tpu_torch.ops import kjma_kernel
    from bdlz_tpu_torch.parallel import run_sweep

    if pid == 1:
        kjma_kernel.kernel_digest = lambda: "f" * 16  # another build
    cfg, static = _cfg()
    try:
        run_sweep(cfg, _axes(), static, mesh=_mesh(), chunk_size=4, n_y=2000, impl="kernel")
    except RuntimeError as exc:
        assert "kernel library digest differs across hosts" in str(exc), exc
        print(f"worker {pid} KNOB-MISMATCH-RAISED")
        return
    raise AssertionError("divergent kernel digest did not raise")


def cache(pid, out):
    import numpy as np

    from bdlz_tpu_torch.parallel import run_sweep

    cfg, static = _cfg()
    static = static._replace(quad_panel_gl=False)
    kw = dict(mesh=_mesh(), chunk_size=4, n_y=2000, cache=f"{out}/store")
    cold = run_sweep(cfg, _axes(), static, **kw)
    assert cold.n_failed == 0
    assert cold.cache_hits == 0 and cold.cache_misses == cold.chunks == 2
    warm = run_sweep(cfg, _axes(), static, **kw)
    assert warm.cache_hits == 2 and warm.cache_misses == 0, (warm.cache_hits, warm.cache_misses)
    np.testing.assert_array_equal(cold.outputs["DM_over_B"], warm.outputs["DM_over_B"])
    np.savez(f"{out}/result_p{pid}.npz", **warm.outputs)


def rollout(pid, out):
    from bdlz_tpu_torch.serve.rollout import RolloutError, _agree_cutover

    staged = {"equal": ("a" * 16, True),
              "skew": ("a" * 16 if pid == 0 else "b" * 16, True),
              "cold": ("a" * 16, pid == 0)}
    outcome = {}
    for case, (h, warmed) in staged.items():
        try:
            _agree_cutover(h, warmed)
            outcome[case] = None
        except RolloutError as exc:
            outcome[case] = str(exc)
    print(json.dumps(outcome))


def main() -> None:
    mode, port, pid, out = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]

    from bdlz_tpu_torch.parallel import init_multihost, process_count

    assert init_multihost(f"localhost:{port}", 2, pid) is True
    # idempotent: a second call is a no-op
    assert init_multihost(f"localhost:{port}", 2, pid) is True
    assert process_count() == 2
    globals()[mode](pid, out)
    print(f"worker {pid} OK")
    sys.stdout.flush()
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
