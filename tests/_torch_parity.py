"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
the same numpy inputs go to the JAX package and to the port. JAX is
imported inside the helpers that need it."""
import numpy as np
import torch


def t(a) -> torch.Tensor:
    """numpy / JAX array -> torch CPU tensor (uint32 bits viewed as int32)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True))


def n(x) -> np.ndarray:
    """JAX array or torch tensor -> numpy, uint32 bits viewed as int32."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def assert_bits_equal(got, want):
    got, want = n(got), n(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want)


def assert_close(got, want, rtol=1e-5):
    """Float parity: rtol plus an absolute floor of rtol * max|want|."""
    got, want = n(got), n(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def cnn_reference(jmod, image, bits, batch=2, classes=10):
    """A JAX CNN (``repro.models.cnn`` module) at ``image`` px: its param
    tree from PRNGKey(0), ``batch`` images from numpy seed 0, and its float
    and <bits:bits> int-direct logits run op by op (``jax.disable_jit``,
    the reference's unfused arithmetic)."""
    import jax

    from repro.core import PIMQuantConfig

    jparams = jmod.init(jax.random.PRNGKey(0), num_classes=classes,
                        image=image)
    x = np.random.default_rng(0).standard_normal(
        (batch, image, image, 3)).astype(np.float32)
    cfg = PIMQuantConfig(bits, bits, backend="int-direct")
    with jax.disable_jit():
        want = np.asarray(jmod.apply(jmod.prepack(jparams, cfg), x, cfg=cfg))
        want_float = np.asarray(jmod.apply(jparams, x, cfg=None))
    return dict(jparams=jparams, x=x, want=want, want_float=want_float,
                bits=bits)


def check_cnn_logits(tmod, ref, params, backend):
    """The port's ``tmod`` on the converted ``params`` against ``ref``
    (:func:`cnn_reference`): rtol 1e-4 with an absolute floor of
    1e-4*max|logit|, and the same top-1."""
    from repro_torch.core import PIMQuantConfig

    cfg = PIMQuantConfig(ref["bits"], ref["bits"], backend=backend) \
        if backend else None
    x = torch.from_numpy(ref["x"])
    with torch.inference_mode():
        got = tmod.apply(tmod.prepack(params, cfg) if cfg else params, x,
                         cfg=cfg)
    want = ref["want"] if cfg else ref["want_float"]
    assert_close(got, want, rtol=1e-4)
    assert np.array_equal(got.numpy().argmax(-1), want.argmax(-1))


def check_tree_carried(jparams, tree, own):
    """Every leaf of the JAX tree ``jparams`` arrived in ``tree`` as a
    float32 CPU tensor with the same values, and ``tree`` has the shapes
    of the port's own init ``own``."""
    import jax

    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        got = tree
        for key in path:
            got = got[key.key]
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))

    def shapes(t):
        return {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) \
            else tuple(t.shape)

    assert shapes(own) == shapes(tree)
