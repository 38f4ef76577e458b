"""ServingBundle through its torch.export programs, on the CPU.

Bundles at tests/test_torch_export.py's sizes (N = 20 exemplars; binary
12x12 and continuous 8x8x3 raw uint8 input; n_gen 3, ref_batch 2,
score_chunk 4, S = 6 in rounds of r = 3), written by the port's
export_serving_bundle and served by ServingBundle.load from the programs
alone (no model is built):

* each program equals the live make_serving_fns function bitwise on the
  same injected noise (VAE, HVAE and ConvHVAE on binary and continuous
  input, and a standard-prior bundle without a bank), and the same
  generator seed gives the same outputs through both;
* the weights are an input: a bundle whose arrays.npz holds another seed's
  weights serves what the live model with those weights serves;
* the score_nll program holds the custom op once per round and no inlined
  plain LSE (a scan-prior program inlines it); the op passes
  torch.library.opcheck;
* the loader refuses a device outside the manifest's platforms and a
  missing program, and loads no model code (a fresh interpreter);
* against the JAX package's serving functions on the same weights and
  replayed draws, at tests/test_torch_serving.py's tolerances (decoder
  means rtol 1e-5 / atol 1e-5, NLLs rtol 1e-5 / atol 1e-4).
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplar_vae_tpu.config import Config as JConfig
from exemplar_vae_tpu.models import create_model as j_create_model
from exemplar_vae_tpu.serve import make_serving_fns as j_serving_fns
from exemplar_vae_tpu.train.evaluation import make_eval_bank_fn as j_bank_fn
from exemplar_vae_tpu.train.loss import Bank as JBank
from exemplar_vae_tpu_torch import serve
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.ops import pairwise_lse as tpl
from exemplar_vae_tpu_torch.serve import (PROGRAMS, ServingBundle,
                                          export_serving_bundle,
                                          make_serving_fns)
from exemplar_vae_tpu_torch.weights import params_from_flax, params_to_keystr
from test_torch_export import (N, ROUNDS, SIZES, _cfg, _eval_bank, _images,
                               _iwae_noise, _noise)
from test_torch_serving import (IMG_TOL, NLL_TOL, Z, _gen_draws,
                                _round_eps)

ROOT = Path(__file__).resolve().parents[1]
OP = "exemplar_vae_tpu_torch.pairwise_lse.default"
EXEMPLAR = [(name, input_type) for name in ("vae", "hvae_2level",
                                            "convhvae_2level")
            for input_type in ("binary", "continuous")]


def _export(model, cfg, eb, d):
    bank = {} if eb is None else dict(
        bank_means=eb.cache_means, data_idx=eb.data_idx, valid=eb.valid,
        n_effective=N)
    export_serving_bundle(model, cfg, str(d), **bank, **SIZES)
    return ServingBundle.load(str(d), device="cpu")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(cfg, model, eval bank or None, bundle dir, loaded bundle) of one
    family, input type and prior; each exported and loaded once."""
    cache = {}

    def get(name, input_type, prior="exemplar_prior"):
        key = (name, input_type, prior)
        if key not in cache:
            cfg = _cfg(name, input_type, prior)
            model = create_model(cfg, device="cpu", seed=3).eval()
            eb = (_eval_bank(model, cfg, _images(N, input_type, 1))
                  if prior == "exemplar_prior" else None)
            d = tmp_path_factory.mktemp("-".join(key))
            cache[key] = (cfg, model, eb, d, _export(model, cfg, eb, d))
        return cache[key]

    return get


def _live(model, cfg, eb):
    """The live serving functions, the bank bound as the bundle binds it."""
    gen, ref, score = make_serving_fns(model, cfg, 0 if eb is None else N,
                                       SIZES["n_gen"], ROUNDS, SIZES["r"])
    bank = () if eb is None else (eb.cache_means, eb.data_idx, eb.valid)
    return (lambda **kw: gen(bank[0] if bank else None, **kw), ref,
            lambda x, **kw: score(x, *bank, **kw))


def _assert_serves_live(b, live, cfg, input_type, idx):
    gen, ref, score = live
    x = _images(4, input_type, 2)
    e = _iwae_noise(cfg, 4, 4)
    mean, per = b.score_nll(x, eps=[e])
    want = score(x, eps=e).numpy()
    assert np.array_equal(per, want) and mean == float(want.mean())
    eps, eps1 = _noise(cfg, 3, 5)
    assert torch.equal(b.generate(idx=idx, eps=eps, eps1=eps1),
                       gen(idx=idx, eps=eps, eps1=eps1))
    eps, eps1 = _noise(cfg, 2, 6)
    assert torch.equal(b.reference_generate(x[:2], eps=eps, eps1=eps1),
                       ref(x[:2], eps=eps, eps1=eps1))


@pytest.mark.parametrize("name,input_type,prior",
                         [(n, i, "exemplar_prior") for n, i in EXEMPLAR]
                         + [("hvae_2level", "binary", "standard")])
def test_programs_equal_live_serving(served, name, input_type, prior):
    cfg, model, eb, d, b = served(name, input_type, prior)
    assert b.model is None and b.manifest["platforms"] == ["cpu"]
    with np.load(d / "arrays.npz") as data:
        assert ("bank_means" in data.files) == (eb is not None)
    _assert_serves_live(b, _live(model, cfg, eb), cfg, input_type,
                        None if eb is None else np.array([0, 7, 19]))


@pytest.mark.parametrize("name", ["vae", "hvae_2level"])
def test_same_generator_seed_as_live(served, name):
    """The loader draws each program's noise in the live functions' order
    (idx, eps, eps1; the IWAE's z2 then z1 noise per round), so one
    generator through score_nll, generate and reference_generate gives the
    live outputs."""
    cfg, model, eb, _, b = served(name, "binary")
    gen, ref, score = _live(model, cfg, eb)
    x = _images(4, "binary", 2)
    g_prog = torch.Generator().manual_seed(9)
    g_live = torch.Generator().manual_seed(9)
    assert np.array_equal(b.score_nll(x, generator=g_prog)[1],
                          score(x, generator=g_live).numpy())
    assert torch.equal(b.generate(generator=g_prog), gen(generator=g_live))
    assert torch.equal(b.reference_generate(x[:2], generator=g_prog),
                       ref(x[:2], generator=g_live))
    assert torch.equal(g_prog.get_state(), g_live.get_state())


def test_weights_are_an_input(served, tmp_path):
    """arrays.npz's weights swapped for another seed's: the same programs
    serve what the live model with those weights serves."""
    cfg, _, eb, d, _ = served("hvae_2level", "binary")
    other = create_model(cfg, device="cpu", seed=7).eval()
    shutil.copytree(d, tmp_path, dirs_exist_ok=True)
    with np.load(d / "arrays.npz") as data:
        arrays = {k: data[k] for k in data.files if not k.startswith("param:")}
    arrays.update(params_to_keystr(other.state_dict(), "param:"))
    np.savez(tmp_path / "arrays.npz", **arrays)
    b = ServingBundle.load(str(tmp_path), device="cpu")
    _assert_serves_live(b, _live(other, cfg, eb), cfg, "binary",
                        np.array([1, 2, 3]))
    del arrays["param:['q_z1_x']['h_bias']"]
    np.savez(tmp_path / "arrays.npz", **arrays)
    with pytest.raises(ValueError, match="missing.*q_z1_x.h_bias"):
        ServingBundle.load(str(tmp_path), device="cpu")


def _targets(program):
    """Targets of every call in a loaded program's graph, nested graphs
    included."""
    return [str(n.target) for gm in program.module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for n in gm.graph.nodes if n.op == "call_function"]


def _inlines_plain_lse(targets):
    """The plain LSE's tile: z @ mu.T (aten.mm) and the sq >= 0 clamp."""
    return any(t.startswith(("aten.mm.", "aten.clamp_min.")) for t in targets)


@pytest.mark.parametrize("name,input_type", EXEMPLAR)
def test_score_program_holds_the_op(served, name, input_type):
    *_, b = served(name, input_type)
    for prog in PROGRAMS:
        targets = _targets(b.programs[prog])
        assert targets.count(OP) == (ROUNDS if prog == "score_nll" else 0)
        assert not _inlines_plain_lse(targets), prog


def test_scan_prior_program_inlines_the_plain_lse(tmp_path):
    """With use_pallas_prior off the program holds the scan, not the op:
    the marks the test above looks for."""
    cfg = _cfg("vae", "binary").replace(use_pallas_prior=False)
    model = create_model(cfg, device="cpu", seed=3).eval()
    b = _export(model, cfg, _eval_bank(model, cfg, _images(N, "binary", 1)),
                tmp_path)
    targets = _targets(b.programs["score_nll"])
    assert OP not in targets and _inlines_plain_lse(targets)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("loo", [False, True])
def test_op_passes_opcheck(loo, in_dtype):
    rng = np.random.default_rng(0)
    means = torch.from_numpy(rng.normal(size=(30, 5)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32))
    ex = torch.arange(30, dtype=torch.int32)
    valid = torch.from_numpy(rng.random(30) > 0.1)
    didx = torch.tensor([0, 3, 3, 29, 7, 11, 2], dtype=torch.int32)
    args = (z, means, torch.tensor(-0.4), didx if loo else None, ex, valid,
            in_dtype, 8)
    torch.library.opcheck(torch.ops.exemplar_vae_tpu_torch.pairwise_lse.default,
                          args)
    torch.testing.assert_close(
        torch.ops.exemplar_vae_tpu_torch.pairwise_lse(*args),
        tpl.pairwise_lse_plain(*args[:6], in_dtype=in_dtype, block_n=8),
        rtol=0, atol=0)


def test_load_refuses_a_device_outside_the_platforms(served, monkeypatch):
    *_, d, _ = served("vae", "binary")
    monkeypatch.setattr(serve, "resolve_device", torch.device)
    with pytest.raises(ValueError, match=r"exported for \['cpu'\]"):
        ServingBundle.load(str(d), device="cuda")


def test_missing_program_raises(served, tmp_path):
    """A listed program that is gone raises; the loader does not build the
    model instead."""
    *_, d, _ = served("vae", "binary")
    shutil.copytree(d, tmp_path, dirs_exist_ok=True)
    (tmp_path / "score_nll.pt2").unlink()
    with pytest.raises(FileNotFoundError, match="score_nll.pt2"):
        ServingBundle.load(str(tmp_path), device="cpu")


def test_serving_loads_no_model_code(served):
    """A fresh interpreter loads a bundle and serves all three programs;
    no module of exemplar_vae_tpu_torch.models, JAX or the JAX package is
    loaded."""
    *_, d, _ = served("vae", "continuous")
    code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        "from exemplar_vae_tpu_torch.serve import ServingBundle\n"
        "b = ServingBundle.load(sys.argv[1], device='cpu')\n"
        "g = torch.Generator().manual_seed(0)\n"
        "x = np.zeros((5, 8, 8, 3), np.uint8)\n"
        "_, per = b.score_nll(x, generator=g)\n"
        "out = [per.shape[0], bool(np.isfinite(per).all()),\n"
        "       list(b.generate(generator=g).shape),\n"
        "       list(b.reference_generate(x[:2], generator=g).shape)]\n"
        "mods = [m for m in sys.modules if m.split('.')[0] in\n"
        "        ('jax', 'exemplar_vae_tpu', 'exemplar_vae_tpu_torch')]\n"
        "print(json.dumps([out, mods]))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(d)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out, mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == [5, True, [SIZES["n_gen"], 8, 8, 3], [2, 8, 8, 3]]
    assert "exemplar_vae_tpu_torch.serve" in mods
    assert not [m for m in mods if m.startswith(
        ("jax", "exemplar_vae_tpu.", "exemplar_vae_tpu_torch.models"))
        or m == "exemplar_vae_tpu"], mods


def test_programs_match_jax_serving(tmp_path):
    """A VAE with flax's init params: the bundle's programs (the op, its
    plain version here) against the JAX package's serving functions (scan
    prior) with JAX's draws replayed (tests/test_torch_serving.py's key
    splits)."""
    jcfg = JConfig(model_name="vae", prior="exemplar_prior",
                   input_size=(1, 12, 12), input_type="binary",
                   dynamic_binarization=False, hidden_size=16, z1_size=Z,
                   number_components=N, use_pallas_prior=False,
                   prior_block_n=8, prior_variance_init=0.5)
    jm = j_create_model(jcfg)
    k = jax.random.PRNGKey(0)
    x = _images(N, "binary", 1)
    params = jm.init(k, jnp.asarray(x[:2]), k)["params"]
    jeb = j_bank_fn(jm, jcfg)(params, JBank(
        images=jnp.asarray(x), data_idx=jnp.arange(N, dtype=jnp.int32),
        valid=jnp.ones(N, bool), cache_means=None, n_effective=N), k)
    cfg = Config.from_json(jcfg.to_json()).replace(use_pallas_prior=True)
    model = create_model(cfg, device="cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    eb = _eval_bank(model, cfg, x)
    export_serving_bundle(model, cfg, str(tmp_path), bank_means=eb.cache_means,
                          data_idx=eb.data_idx, valid=eb.valid, n_effective=N,
                          n_gen=5, ref_batch=4, score_chunk=4, s_total=8, r=4)
    b = ServingBundle.load(str(tmp_path), device="cpu")
    assert b.model is None
    assert _targets(b.programs["score_nll"]).count(OP) == 2
    jgen, jref, jscore = j_serving_fns(jm, jcfg, N, 5, 2, 4)
    key = jax.random.PRNGKey(3)
    idx, eps = _gen_draws(key, 5, N)
    np.testing.assert_allclose(
        b.generate(idx=idx, eps=eps).numpy(),
        np.asarray(jgen(params, jeb.cache_means, key)), **IMG_TOL)
    _, k_z, _ = jax.random.split(key, 3)
    np.testing.assert_allclose(
        b.reference_generate(x[:4], eps=np.array(
            jax.random.normal(k_z, (4, Z)))).numpy(),
        np.asarray(jref(params, jnp.asarray(x[:4]), key)), **IMG_TOL)
    _, per = b.score_nll(x[:4], eps=[_round_eps(key, 2, 4 * 4)])
    np.testing.assert_allclose(
        per, np.asarray(jscore(params, jnp.asarray(x[:4]), key,
                               jeb.cache_means, jeb.data_idx, jeb.valid)),
        **NLL_TOL)
