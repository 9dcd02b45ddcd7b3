"""PyTorch port, the Table IV CNN: the synthetic images byte-equal to the
JAX package's, its `init_cnn` weights carried over, the hardware-mode
forward of every family against the JAX forward, the benchmark's
reference-semantics evaluation against the JAX benchmark's, and float
SGD steps against the JAX steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import table4_cnn as j_table4
from repro.data.pipeline import image_batch as j_image_batch
from repro.models import cnn as j_cnn
from repro.models.common import CiMContext as JCiMContext
from repro.models.common import CiMParams as JCiMParams
from repro_torch.core.approx_gemm import plan_misses
from repro_torch.data.pipeline import image_batch
from repro_torch.launch import table4_cnn
from repro_torch.models import cnn
from repro_torch.models.bridge import cnn_params_from_numpy
from repro_torch.models.common import CiMContext, CiMParams

FAMS = ["exact", "appro42", "log_our", "mitchell"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch ops, restored after it.
    Its ops are small; next to the other test workers on the same cores,
    torch's default pool (a thread a core) spends its time waiting for
    cores those workers hold, not computing."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _numpy_tree(tree):
    return {k: np.asarray(getattr(v, "value", v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def jparams():
    return j_cnn.init_cnn(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jparams_w8():
    return j_cnn.init_cnn(jax.random.PRNGKey(1), width=8)


@pytest.mark.parametrize("n,hw,noise,seed", [(5, 16, 0.32, 0),
                                             (7, 16, 0.55, 123),
                                             (3, 32, 0.32, 4)])
def test_image_batch_is_byte_equal(n, hw, noise, seed):
    got = image_batch(np.random.default_rng(seed), n, hw=hw, noise=noise)
    want = j_image_batch(np.random.default_rng(seed), n, hw=hw, noise=noise)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_bridge_carries_init_cnn(jparams):
    tree = _numpy_tree(jparams)
    params = cnn_params_from_numpy(tree, "cpu")
    assert sorted(params) == sorted(tree)
    for k, v in tree.items():
        assert params[k].dtype == torch.float32
        assert params[k].numpy().tobytes() == v.tobytes()
    # the port's own init has the reference's names and shapes
    own = cnn.init_cnn(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in tree.items()}


@pytest.mark.parametrize("fam", FAMS)
def test_cnn_forward_hardware_matches_jax(jparams_w8, fam):
    """Per family, the hardware-mode forward (the implicit conv kernels'
    and fused GEMM kernels' plain versions) against the JAX package's
    (its Pallas kernels in interpret mode) on the same weights and
    images.  The integer cores are bitwise equal on identical inputs
    (test_torch_conv.py, test_torch_kernels.py); the logits (|logit| ~
    0.1 at init) are held to 1e-5 absolute, for the f32 sums that the two
    frameworks take in other orders (the global mean pool; XLA's jitted
    x / (max|x| / qmax))."""
    xs, _ = image_batch(np.random.default_rng(5), 4, hw=8)
    params = cnn_params_from_numpy(_numpy_tree(jparams_w8), "cpu")
    ctx = CiMContext(CiMParams(mode="hardware", family=fam, bits=8))
    got = cnn.cnn_forward(params, torch.from_numpy(xs), ctx)
    want = np.asarray(j_cnn.cnn_forward(
        jparams_w8, jnp.asarray(xs),
        JCiMContext(JCiMParams(mode="hardware", family=fam, bits=8))))
    assert got.shape == (4, 10) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5)
    # fused == the im2col oracle, bit for bit, within the port
    base = cnn.cnn_forward(params, torch.from_numpy(xs), ctx, fused=False)
    assert torch.equal(got, base)


def test_evaluate_matches_reference_top1_top5(jparams):
    """The benchmark's reference-semantics evaluation (exact mode for the
    exact family, the bit-exact LUT gather for the others) gives the JAX
    benchmark's top-1 and top-5 on its first 32 shifted images."""
    params = cnn_params_from_numpy(_numpy_tree(jparams), "cpu")
    for fam in FAMS:
        assert table4_cnn.evaluate(params, fam, n=32) == \
            j_table4.evaluate(jparams, fam, n=32), fam


def test_hardware_evaluation_routes_only_kernels_and_repeats(jparams):
    """evaluate_hardware runs; after its first forward no plan is built."""
    params = cnn_params_from_numpy(_numpy_tree(jparams), "cpu")
    first = table4_cnn.evaluate_hardware(params, "log_our", n=8)
    n0 = plan_misses()
    assert table4_cnn.evaluate_hardware(params, "log_our", n=8) == first
    assert plan_misses() == n0


def test_sgd_steps_match_jax(jparams):
    """Three float SGD steps (the benchmark's training, no CiM): losses
    and weights within 1e-5 of the JAX steps (f32 sums in other orders
    on the two sides)."""
    rng_t, rng_j = np.random.default_rng(0), np.random.default_rng(0)
    params = cnn_params_from_numpy(_numpy_tree(jparams), "cpu")

    @jax.jit
    def jstep(p, batch):
        (loss, acc), g = jax.value_and_grad(j_cnn.cnn_loss,
                                            has_aux=True)(p, batch)
        return jax.tree_util.tree_map(lambda a, b: a - 0.05 * b, p, g), loss

    jp = jparams
    for _ in range(3):
        xs, ys = image_batch(rng_t, 64, hw=16)
        params, loss, _ = table4_cnn.sgd_step(
            params, {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)})
        xj, yj = j_image_batch(rng_j, 64, hw=16)
        jp, jloss = jstep(jp, {"x": jnp.asarray(xj), "y": jnp.asarray(yj)})
        assert abs(loss - float(jloss)) <= 1e-5 * max(1.0, abs(loss))
    for k, v in _numpy_tree(jp).items():
        np.testing.assert_allclose(params[k].numpy(), v, rtol=1e-5,
                                   atol=1e-5)


def test_table4_launcher_runs_on_the_cpu(capsys):
    out = table4_cnn.run(steps=2, n=8, mode="both", device="cpu")
    assert set(out) == {"reference", "hardware"}
    for results in out.values():
        assert list(results) == FAMS
        assert all(0.0 <= t1 <= t5 <= 1.0 for t1, t5 in results.values())
    text = capsys.readouterr().out
    assert "claims" in text and "mitchell" in text
