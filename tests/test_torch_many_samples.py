"""Rays of more than 256 samples: a hierarchical step with a 320-sample fine
pass, the port against the JAX system on the CPU, and the sample limits of
the per-ray kernels.

The JAX kernels size their ray tile from S and take any number of samples
(satnerf_tpu/ops/pallas/fused_mlp.py:1847, fused_nerf.py:685). The port's
per-ray training kernels keep a ray's per-sample values in shared memory, so
on the card they take as many samples as fit the 227 KB a block may hold
(ops/fused_mlp.py composite_max_samples, ops/fused_nerf.py
nerf_composite_max_samples, which mirror their C entries). Here the plain
versions run: `--n_importance 304` over 16 samples (a fine pass of 320) in
the port's "rays" mode (the per-ray chains K1, K3 and K4) and "off" mode,
against `--fused off` of the JAX system, with the JAX renders' draws
injected as tests/test_torch_train_hier.py does: loss parts 2e-5,
gradients 1e-4 of each tensor's largest entry, then one train_step's
parameters 2e-5.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.config import Config as JaxConfig
from satnerf_tpu.train.system import NeRFSystem as JaxSystem
from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.ops import fused_mlp as FM
from satnerf_tpu_torch.ops import fused_nerf as FN
from satnerf_tpu_torch.train.checkpoints import adam_from_jax, params_from_jax
from satnerf_tpu_torch.train.system import NeRFSystem
from tests.test_torch_render_hier import jax_render_draws

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "satnerf_tpu_torch", "csrc")

B, N_DATA, LAYERS, S, N_IMP = 6, 24, 4, 16, 304
KW = dict(batch_size=B, fc_units=32, fc_layers=LAYERS, n_samples=S,
          n_importance=N_IMP, max_train_steps=30, first_beta_epoch=2, lr=1e-3,
          sc_lambda=0.1)


def _data(seed=1):
    rng = np.random.RandomState(seed)
    rays = rng.rand(N_DATA, 11).astype(np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    rays[:, 8:11] /= np.linalg.norm(rays[:, 8:11], axis=1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.0, 1.0
    rgbs = rng.rand(N_DATA, 3).astype(np.float32)
    ts = rng.randint(0, 5, N_DATA).astype(np.int32)
    return rays, rgbs, ts


def _draws(key, rays):
    d = jax_render_draws(jax.random.split(key)[0], rays, S, N_IMP, None)
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()
            if v is not None}


def _jax_step(system, params, data, idx, key, step):
    def loss_fn(p):
        return system._loss_and_metrics(
            p, *(jnp.asarray(a[idx]) for a in data), key,
            jnp.asarray(step, jnp.int32))

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


@pytest.mark.parametrize("fused", ["rays", "off"])
def test_fine_pass_of_320_samples_matches_jax(eight_devices, fused):
    """One step at 16 + 304 samples a ray: loss_and_grads against the JAX
    XLA path, then train_step from bridged weights and Adam state."""
    # step 0: the beta gate off, Adam's first update at the schedule's first rate
    variant, step = "sat-nerf", 0
    data = _data()
    idx = np.random.RandomState(7).randint(0, N_DATA, B)
    key = jax.random.PRNGKey(11)
    sys_j = JaxSystem(JaxConfig(model=variant, fused="off", noise_std=0.0,
                                **KW), dataset_len=N_DATA)
    params = sys_j.init_params(jax.random.PRNGKey(0))
    (loss_j, m_j), g_j = _jax_step(sys_j, params, data, idx, key, step)
    draws = _draws(key, data[0][idx])
    assert draws["z_vals"].shape == (B, S) and draws["u"].shape == (B, N_IMP)

    sys_t = NeRFSystem(Config(model=variant, fused=fused, noise_std=0.0, **KW),
                       device="cpu", dataset_len=N_DATA)
    assert sys_t.fused_mode == fused
    named = params_from_jax(jax.device_get(params), variant, LAYERS)
    state = sys_t.init_state(0)
    state.params.load_state_dict(named)
    batch = [torch.from_numpy(a[idx]) for a in data]
    loss_t, m_t, grads = sys_t.loss_and_grads(
        state.params, batch[0], batch[1], batch[2].long(), step, **draws)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=2e-5,
                               rtol=2e-5)
    for k in ("loss", "loss_total"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), atol=2e-5,
                                   rtol=2e-5, err_msg=k)
    want = params_from_jax(jax.device_get(g_j), variant, LAYERS)
    assert set(grads) == set(want)
    assert any(k.startswith("nerf_fine.") for k in grads)
    for name, ref in want.items():
        ref = ref.numpy()
        scale = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(grads[name].detach().numpy() / scale,
                                   ref / scale, atol=1e-4, err_msg=name)

    # one Adam step from the same state on both sides
    opt_state = sys_j.tx.init(params)
    updates, _ = sys_j.tx.update(g_j, opt_state, params)
    new = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    adam = opt_state[0]
    adam_from_jax(state.optimizer, state.params, jax.device_get(adam.mu),
                  jax.device_get(adam.nu), int(adam.count), variant, LAYERS)
    state.step = step
    t_data = {"rays": torch.from_numpy(data[0]),
              "rgbs": torch.from_numpy(data[1]),
              "ts": torch.from_numpy(data[2]).long()}
    sys_t.train_step(state, t_data, idx=torch.from_numpy(idx), **draws)
    got = state.params.state_dict()
    for name, ref in params_from_jax(jax.device_get(new), variant,
                                     LAYERS).items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("feat,fh,body,want", [
    (512, 256, "block", 4129),  # the main path's 8 x 512 field
    (512, 256, "warp", 1452),
    (256, 128, "block", 4296),  # --fc_units 256
    (256, 128, "warp", 1452),
    (96, 48, "block", 4401)])   # the capability presets' width
def test_composite_sample_limit(feat, fh, body, want):
    """The largest S whose shared memory fits the 227 KB a block may hold,
    by the C entry's rule (csrc/fused_train.cu clb2_smem_floats; the warp
    body's CLB_WARPS x CLB_SAMPLE_VALS floats a sample): S fits, S + 1 does
    not, and every S the hierarchical configs use fits."""
    limit = FM.composite_max_samples(feat, fh, body)
    assert limit == want
    assert FM._composite_smem_bytes(feat, fh, limit, body) <= FM.SMEM_OPTIN_BYTES
    assert FM._composite_smem_bytes(feat, fh, limit + 1, body) > FM.SMEM_OPTIN_BYTES
    assert limit >= 64 + 256  # --n_importance 256 over the default 64
    if body == "block":  # past one chunk of 256 the transmittance is kept too
        assert (FM._composite_smem_bytes(feat, fh, 257, body)
                - FM._composite_smem_bytes(feat, fh, 256, body)) == 4 * 13 + 4 * 256


@pytest.mark.parametrize("name", ["composite_loss_bwd", "composite_bwd"])
@pytest.mark.parametrize("body", ["block", "warp"])
def test_composite_refusal_names_the_limit(name, body):
    limit = FM.composite_max_samples(512, 256, body)
    FM._check_samples(name, 512, 256, limit, body)
    with pytest.raises(ValueError, match=rf"227 KB.*at most {limit} at F=512, Fh=256"):
        FM._check_samples(name, 512, 256, limit + 1, body)


def test_nerf_composite_sample_limit():
    """The block body's shared memory (csrc/fused_nerf.cu ncl_smem_bytes):
    eight floats a sample, nine past one chunk of 256, beside the rows and
    each warp's columns of dWn. With no widths given the limit is that of
    the widest operands the kernel takes (F = 512, Fh = 256, fp32): 5,172
    samples a ray, which every width holds; not below the 1,816 of the warp
    walk it replaced."""
    limit = FN.nerf_composite_max_samples()
    assert limit == 5172 and limit >= 1816
    assert FN._ncl_smem_bytes(512, 256, limit, 4) <= FM.SMEM_OPTIN_BYTES
    assert FN._ncl_smem_bytes(512, 256, limit + 1, 4) > FM.SMEM_OPTIN_BYTES
    for feat, fh in ((256, 128), (40, 20), (512, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            assert FN.nerf_composite_max_samples(feat, fh, dtype) >= limit
    assert (FN._ncl_smem_bytes(256, 128, 257, 2)
            - FN._ncl_smem_bytes(256, 128, 256, 2)) == 4 * 8 + 4 * 257


def _c_ncl_smem_bytes():
    """csrc/fused_nerf.cu ncl_smem_bytes as a Python function, read from the
    source with the helpers and constants it names (csrc/heads.cuh,
    csrc/common.cuh): C's integer division as //, its conditional as
    Python's."""
    def read(name):
        with open(os.path.join(CSRC, name)) as f:
            return f.read()

    nerf, heads, common = read("fused_nerf.cu"), read("heads.cuh"), read("common.cuh")

    def body(src, signature):
        expr = re.search(re.escape(signature) + r"\s*\{\s*return (.*?);\s*\}", src, re.S)
        return re.sub(r"(\d+)LL\b", r"\1", " ".join(expr.group(1).split())).replace("/", "//")

    ncl = re.sub(r"\((\w+) > (\w+) \? (\w+) : 0\)", r"(\3 if \1 > \2 else 0)", body(
        nerf, "constexpr long long ncl_smem_bytes(int F, int Fh, int S, int elem_bytes)"))
    rows = body(heads, "constexpr int nerf_rows_smem_bytes(int F, int Fh, int elem_bytes)")
    pad8 = body(heads, "constexpr int heads_pad8(int n)")
    scratch = body(common, "constexpr int block_scratch_floats(int M)")
    assert "constexpr int SCAN_WARPS = SCAN_THREADS / 32;" in common
    assert "constexpr int NCL_THREADS = SCAN_THREADS;" in nerf
    assert "constexpr int NCL_WARPS = SCAN_WARPS;" in nerf
    threads = int(re.search(r"constexpr int SCAN_THREADS = (\d+);", common).group(1))
    env = {"SCAN_WARPS": threads // 32, "NCL_THREADS": threads, "NCL_WARPS": threads // 32,
           "NCL_SUMS": int(re.search(r"constexpr int NCL_SUMS = (\d+);", nerf).group(1))}
    env["heads_pad8"] = lambda n: eval(pad8, {"n": n})
    env["block_scratch_floats"] = lambda m: eval(scratch, dict(env, M=m))
    env["nerf_rows_smem_bytes"] = lambda f, fh, e: eval(
        rows, dict(env, F=f, Fh=fh, elem_bytes=e))
    return lambda feat, fh, n_s, elem: eval(ncl, dict(env, F=feat, Fh=fh, S=n_s,
                                                      elem_bytes=elem))


@pytest.mark.parametrize("feat,fh,dtype,want", [
    (512, 256, torch.float32, 5172),   # the widest operands: every width's floor
    (512, 256, torch.bfloat16, 5244),
    (256, 128, torch.bfloat16, 5848),  # the nerf 8 x 256 field
    (40, 20, torch.float32, 6340)])
def test_nerf_composite_sample_limit_is_the_c_formula(feat, fh, dtype, want):
    """nerf_composite_max_samples: the largest S whose shared memory, by the
    C entry's own formula read from the source, fits the 227 KB a block may
    hold; S fits, S + 1 does not, and the Python mirror gives the same bytes
    at every S."""
    nbytes, elem = _c_ncl_smem_bytes(), torch.finfo(dtype).bits // 8
    limit = FN.nerf_composite_max_samples(feat, fh, dtype)
    assert limit == want
    assert nbytes(feat, fh, limit, elem) <= FM.SMEM_OPTIN_BYTES
    assert nbytes(feat, fh, limit + 1, elem) > FM.SMEM_OPTIN_BYTES
    for n_s in (1, 64, 256, 257, 640, limit):
        assert FN._ncl_smem_bytes(feat, fh, n_s, elem) == nbytes(feat, fh, n_s, elem)
