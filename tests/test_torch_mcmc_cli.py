"""The port's MCMC command line against the JAX package's, on the CPU.

* Flag and pairing refusals: the same ``SystemExit`` message, byte for
  byte.  ``--multihost`` with no process group configured runs as one
  process, as the JAX CLI does.
* The summary JSON has the JAX CLI's keys in the JAX CLI's order for both
  samplers, and ``--out`` writes the JAX CLI's npz schema.
* The CLI's chain is the API's: the initial walkers from ``--seed``, the
  chain from ``--seed`` + 1, bit for bit; a checkpointed CLI run resumes
  every segment.
"""
import json

import numpy as np
import pytest
import torch

from bdlz_tpu.mcmc_cli import main as j_main

from bdlz_tpu_torch.mcmc_cli import main as t_main

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
PARAMS = ["--param", "m_chi_GeV=0.5:2", "--param", "P_chi_to_B=0.01:0.9"]


@pytest.fixture
def cfg(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(ARCHIVED))
    return str(path)


def _profile_csv(tmp_path):
    from bdlz_tpu_torch.lz.profile import BounceProfile, write_profile_csv

    xi = np.linspace(-2.0, 2.0, 201)
    path = str(tmp_path / "prof.csv")
    write_profile_csv(path, BounceProfile(xi=xi, delta=2.0 * xi, mix=np.full_like(xi, 0.3)))
    return path


REFUSALS = {
    "burn": ["--steps", "8", "--burn", "8"],
    "stretch_knob": ["--mass-matrix", "dense"],
    "target_accept": ["--sampler", "nuts", "--target-accept", "1.5"],
    "lz_without_profile": ["--lz-method", "coherent"],
    "table_n_without_profile": ["--lz-table-n", "64"],
    "gamma_without_dephased": ["--lz-gamma-phi", "0.1"],
    "P_with_profile": ["--lz-profile", "PROFILE"],
    "gamma_sampled_not_dephased": ["--lz-profile", "PROFILE", "--param", "v_w=0.1:0.6",
                                   "--param", "lz_gamma_phi=0:0.5"],
    "table_n_local": ["--lz-profile", "PROFILE", "--lz-table-n", "64"],
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_are_byte_equal_to_jax(name, cfg, tmp_path):
    extra = [tmp_path.joinpath("prof.csv").as_posix() if a == "PROFILE" else a
             for a in REFUSALS[name]]
    if "PROFILE" in REFUSALS[name]:
        _profile_csv(tmp_path)
    params = PARAMS if name not in ("gamma_sampled_not_dephased", "table_n_local") else [
        "--param", "m_chi_GeV=0.5:2"]
    if name == "table_n_local":
        params = ["--param", "v_w=0.1:0.6"]
    argv = ["--config", cfg, *params, "--walkers", "8", "--steps", "8", "--burn", "2", *extra]
    with pytest.raises(SystemExit) as ref:
        j_main(argv)
    with pytest.raises(SystemExit) as got:
        t_main(argv + ["--device", "cpu"])
    assert isinstance(ref.value.code, str) and got.value.code == ref.value.code


def test_multihost_flag_runs_as_one_process(cfg, capsys, monkeypatch):
    """With no process group configured ``--multihost`` is the one-process
    run: the same summary and chain as the run without the flag."""
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    args = ["--config", cfg, *PARAMS, "--walkers", "8", "--steps", "6", "--burn", "2",
            "--device", "cpu"]
    t_main(args)
    plain = _summary(capsys)
    t_main(args + ["--multihost"])
    assert _summary(capsys) == plain


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("sampler", ["stretch", "nuts"])
def test_summary_and_npz_schema_match_jax(sampler, cfg, tmp_path, capsys):
    args = ["--config", cfg, *PARAMS, "--steps", "10", "--burn", "2"]
    if sampler == "nuts":
        args += ["--walkers", "2", "--sampler", "nuts", "--nuts-warmup", "12",
                 "--max-tree-depth", "4"]
    else:
        args += ["--walkers", "8"]
    j_main(args + ["--out", str(tmp_path / "j.npz")])
    j_sum = _summary(capsys)
    t_main(args + ["--out", str(tmp_path / "t.npz"), "--device", "cpu"])
    t_sum = _summary(capsys)
    assert list(t_sum) == list(j_sum)
    # the JAX CLI rounds stretch walkers up to its device count (8 virtual
    # CPU devices under the test suite), the port to its one device
    for k in ("steps", "burn", "sampler"):
        assert t_sum[k] == j_sum[k]
    assert t_sum["walkers"] == (2 if sampler == "nuts" else 8)
    for k in ("map_params", "posterior_mean", "tau_int", "split_rhat", "n_eff"):
        assert list(t_sum[k]) == list(j_sum[k])
    if sampler == "nuts":
        assert list(t_sum["nuts"]) == list(j_sum["nuts"])
        assert t_sum["nuts"]["n_logp_evals"] > 10 * 2
    assert np.isfinite(t_sum["map_logp"])
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert (t[k].ndim, t[k].dtype) == (j[k].ndim, j[k].dtype), k
        assert t["chain"].shape == (10, t_sum["walkers"], 2)
        assert t["logp"].shape == (10, t_sum["walkers"])
        np.testing.assert_array_equal(t["param_names"], j["param_names"])


@pytest.fixture(scope="module")
def logp():
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.ops.kjma_table import make_f_table
    from bdlz_tpu_torch.sampling import make_pipeline_logprob

    base = config_from_dict(ARCHIVED)
    bounds = {"m_chi_GeV": (0.5, 2.0), "P_chi_to_B": (0.01, 0.9)}
    return make_pipeline_logprob(base, static_choices_from_config(base),
                                 make_f_table(base.I_p), param_keys=tuple(bounds),
                                 bounds=bounds, device="cpu")


def test_cli_chain_is_the_api_chain(cfg, tmp_path, capsys, logp):
    from bdlz_tpu_torch.mcmc_cli import initial_walkers
    from bdlz_tpu_torch.sampling import run_ensemble
    from bdlz_tpu_torch.sampling.ensemble import make_generator

    t_main(["--config", cfg, *PARAMS, "--walkers", "7", "--steps", "12", "--burn", "2",
            "--seed", "3", "--out", str(tmp_path / "c.npz"), "--device", "cpu"])
    summary = _summary(capsys)
    assert summary["walkers"] == 8      # rounded up to even, as the JAX CLI does
    init = initial_walkers({"m_chi_GeV": (0.5, 2.0), "P_chi_to_B": (0.01, 0.9)}, 8, 3)
    run = run_ensemble(logp, init, 12, generator=make_generator(4))
    with np.load(tmp_path / "c.npz") as data:
        np.testing.assert_array_equal(data["chain"], run.chain.numpy())
        np.testing.assert_array_equal(data["logp"], run.logp_chain.numpy())
    assert summary["acceptance"] == round(run.acceptance, 4)


def test_checkpointed_cli_resumes_every_segment(cfg, tmp_path, capsys):
    argv = ["--config", cfg, *PARAMS, "--walkers", "8", "--steps", "12", "--burn", "2",
            "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "4",
            "--device", "cpu"]
    t_main(argv)
    first = _summary(capsys)
    t_main(argv)
    again = _summary(capsys)
    assert (first["resumed_segments"], again["resumed_segments"]) == (0, 3)
    assert again["posterior_mean"] == first["posterior_mean"]
    assert again["checkpoint_dir"] == str(tmp_path / "ck")


def test_the_default_device_needs_a_card(cfg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main(["--config", cfg, *PARAMS, "--walkers", "8", "--steps", "4", "--burn", "1"])
