"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
the same numpy inputs go to the JAX package and to the port. JAX is
imported inside the helpers that need it."""
import functools

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
        for key in path:   # dict keys, and list indices (the LM trees)
            got = got[key.key if hasattr(key, "key") else key.idx]
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(own) == shapes(tree)


DENSE_ARCHS = ("llama3.2-3b", "qwen3-0.6b", "qwen1.5-4b", "granite-3-2b")


def dense_cfgs(arch, **kw):
    """The reduced ``arch`` in float32 in both packages: (JAX, port)."""
    import dataclasses

    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config

    return tuple(dataclasses.replace(g(arch).model.reduced(), dtype="float32",
                                     **kw)
                 for g in (jget_config, get_config))


def dense_params(jcfg, seed=0):
    """JAX init of ``jcfg`` from PRNGKey(seed), as numpy, with the zero QKV
    biases (qwen1.5) and the unit qk-norm scales (qwen3) redrawn from a
    numpy seed so that their paths count; and the same tree carried to the
    port. Returns (jax tree, port tree)."""
    import jax

    from repro.models.lm import model as jM
    from repro_torch import convert

    jp = jax.device_get(jM.init(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(100 + seed)
    for blk in jp["scan"]:
        a = blk["attn"]
        for k in ("bq", "bk", "bv"):
            if k in a:
                a[k] = (rng.standard_normal(a[k].shape) * 0.5).astype(
                    np.float32)
        for k in ("q_norm", "k_norm"):
            if k in a:
                a[k] = (1 + rng.standard_normal(a[k].shape) * 0.3).astype(
                    np.float32)
    return jp, convert.params_from_jax(jp)


def dense_models(archs=DENSE_ARCHS, seed=0):
    """Each of ``archs``, reduced, float32: configs and one set of weights
    (``dense_params``) in both packages, as {arch: {jc, tc, jp, tp}}."""
    out = {}
    for arch in archs:
        jc, tc = dense_cfgs(arch)
        jp, tp = dense_params(jc, seed)
        out[arch] = dict(jc=jc, tc=tc, jp=jp, tp=tp)
    return out


def normal(rng, shape, scale=1.0) -> np.ndarray:
    """float32 normal draws from a numpy generator."""
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = n(got).astype(np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


HYBRID = "recurrentgemma-9b"


def hybrid_cfgs(**kw):
    """reduced recurrentgemma-9b (float32 unless ``dtype`` is given) in
    both packages: (JAX, port)."""
    import dataclasses

    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config

    kw = {"dtype": "float32", **kw}
    return tuple(dataclasses.replace(g(HYBRID).model.reduced(), **kw)
                 for g in (jget_config, get_config))


def hybrid_params(jcfg, seed=0, dtype=None):
    """JAX init of ``jcfg`` from PRNGKey(seed) as numpy, with the zero
    RG-LRU gate biases redrawn from a numpy seed so that their paths count,
    cast like ``cast_params`` when ``dtype`` is given (a JAX dtype); and the
    same tree carried to the port. Returns (JAX tree, port tree)."""
    import jax

    from repro.models.lm import model as jM
    from repro_torch import convert

    jp = jax.device_get(jax.jit(jM.init, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(200 + seed)
    for blk in jp["scan"] + jp["rest"]:
        rg = blk.get("rglru")
        if rg is not None:
            for k in ("b_a", "b_i"):
                rg[k] = normal(rng, rg[k].shape, 0.5)
    if dtype is not None:
        jp = jax.device_get(jM.cast_params(jp, dtype))
    return jp, convert.params_from_jax(jp)


MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "grok-1-314b")


def moe_cfgs(arch=MOE_ARCHS[0], **kw):
    """The reduced MoE ``arch`` (4 experts, top-2; float32 unless ``dtype``
    is given) in both packages: (JAX, port)."""
    import dataclasses

    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config

    kw = {"dtype": "float32", **kw}
    return tuple(dataclasses.replace(g(arch).model.reduced(), **kw)
                 for g in (jget_config, get_config))


def moe_params(jcfg, seed=0):
    """JAX init of the whole model ``jcfg`` from PRNGKey(seed) as numpy,
    and the same tree carried to the port: (JAX tree, port tree)."""
    import jax

    from repro.models.lm import model as jM
    from repro_torch import convert

    jp = jax.device_get(jax.jit(jM.init, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed)))
    return jp, convert.params_from_jax(jp)


STUB_ARCHS = ("musicgen-large", "llama-3.2-vision-90b")


def stub_cfgs(arch, **kw):
    """The reduced stub-frontend ``arch`` (float32 unless ``dtype`` is
    given) in both packages: (JAX, port)."""
    import dataclasses

    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config

    kw = {"dtype": "float32", **kw}
    return tuple(dataclasses.replace(g(arch).model.reduced(), **kw)
                 for g in (jget_config, get_config))


def stub_params(jcfg, seed=0, gate=0.7):
    """JAX init of ``jcfg`` from PRNGKey(seed) as numpy, with every
    cross-attention gate (0 at init, which zeroes the branch) set to
    ``gate`` plus 0.1 a rep, so that the branch counts and the reps
    differ; and the same tree carried to the port: (JAX tree, port
    tree)."""
    import jax

    from repro.models.lm import model as jM
    from repro_torch import convert

    jp = jax.device_get(jax.jit(jM.init, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed)))
    for blk in jp["scan"] + jp["rest"]:
        a = blk.get("attn", {})
        if "gate" in a:
            g = gate + 0.1 * np.arange(a["gate"].size, dtype=np.float32)
            a["gate"] = g.reshape(a["gate"].shape).astype(np.float32)
    return jp, convert.params_from_jax(jp)


def jax_key(key):
    """The JAX package's key for a port ``repro_torch.pim.faults.Key``:
    its path replayed with ``PRNGKey``, ``fold_in``, ``split`` and the
    engines' ``split(key)[0]`` chain."""
    return _jax_key_path(key.path)


@functools.lru_cache(maxsize=None)
def _jax_key_path(path):
    """Memoized by path, so draws that share a prefix (a leaf, a plane, a
    copy) derive it once."""
    import jax

    if len(path) == 1:
        tag, seed = path[0]
        assert tag == "seed", path
        return jax.random.PRNGKey(seed)
    k, s = _jax_key_path(path[:-1]), path[-1]
    if isinstance(s, int):
        return jax.random.fold_in(k, s)
    if s[0] == "split":
        return jax.random.split(k, s[1])[s[2]]
    for _ in range(s[1]):
        k = jax.random.split(k)[0]
    return k


class JaxDrawer:
    """A fault drawer (``repro_torch.pim.faults.use_drawer``) that draws
    ``jax.random.bernoulli`` on the JAX package's key for each draw's
    path, so the port's corruption can be held bit for bit against the
    reference. ``draws`` counts its draws."""

    def __init__(self):
        self.draws = 0

    def bernoulli(self, key, rate, shape, device):
        self.draws += 1
        bits = np.asarray(_jax_bernoulli(tuple(shape))(
            jax_key(key), np.float32(rate)))
        return torch.from_numpy(bits.astype(np.uint8)).to(device)


@functools.lru_cache(maxsize=None)
def _jax_bernoulli(shape):
    """``jax.random.bernoulli`` at one shape, jitted once for every rate
    (the rate as float32, the type the reference's draw compares in)."""
    import jax

    return jax.jit(lambda k, p: jax.random.bernoulli(k, p, shape))
