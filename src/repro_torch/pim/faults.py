"""NAND-SPIN device-fault model + ECC-style mitigation (the JAX package's
``pim.faults``).

The paper's cells are STT-MRAM devices: programming is stochastic (a write
leaves the MTJ in the wrong state with probability ``write_ber``), reads
disturb the stored state (``read_disturb_ber`` per sensed bit), retention
flips accumulate, and manufacturing leaves stuck-at cells and whole dead
subarrays. Every weight bit lives in one bit-plane subarray, so every
fault is drawn on the bit-plane decomposition of the integer codes and
rendered into the representation a backend reads: the codes for
``int-direct`` / ``mxu-plane``, the packed planes for ``popcount`` /
``cuda``, the fused conv layout for kernel 3. Corrupted codes and planes
describe the same device state, so the backends stay bit for bit equal.

  * persistent (at subarray programming, :func:`inject_packed` /
    :func:`inject_tree`): write errors, retention flips, stuck-at-0/1
    cells, dead subarrays (a dead subarray reads all-zero for its column
    group). The corrupted codes are re-packed through kernel 1
    (``core.packed.repack_codes``).
  * transient (at every read, :func:`read_disturb_scope`): read-disturb
    flips drawn afresh for each bit-serial product inside the scope, and
    XOR-ed into the form the backend reads (the masks packed through
    kernel 1).

Mitigation: the top ``protect_msb`` planes are stored ``vote_copies``
times and majority-voted; the column-sum checksum (:func:`verify_columns`)
compares the stored codes' sums with the golden ``col_sums`` (the affine
correction's Sw register); :func:`repair_packed` remaps up to
``spare_cols`` flagged columns per subarray onto spares, re-programmed
from the golden weights.

**Draws as data.** Every Bernoulli draw goes through one drawer, which is
given the draw's :class:`Key`: the JAX package's key path for it (the
root seed, then the ``fold_in`` / ``split`` chain: leaf index, rep or
expert index, plane ``b``, copy ``r``, mechanism tag; for a read, the
site index). The default drawer (:class:`TorchDrawer`) seeds a
``torch.Generator`` on the draw's device from the path, so a draw is a
function of its key alone, as in the reference. A test can install a
drawer (:func:`use_drawer`) that computes ``jax.random.bernoulli`` on the
reference's key for the same path, which holds the port's corruption bit
for bit against the JAX package without the port touching JAX.

**Stacked leaves.** A scan-stacked LM leaf is a list of R PackedWeights in
the port, one stacked leaf in the reference: :func:`inject_tree` treats
the list as one leaf (one leaf key, per-rep keys as ``split(key, R)``,
counted once). An (E, K, N) expert bank takes per-expert keys
(``split(key, E)``), as the reference's ``vmap`` does; a stacked bank
nests both.

**Read sites.** The reference numbers read sites at trace time: each
scan-stacked call site draws one field per decode step, shared by every
rep (the model rewinds the site counter at each rep, :func:`site_mark`);
each remainder layer is a site of its own; an MoE bank's (K, N) field is
shared by all its experts. Fields are kept per site for the scope's
lifetime, so a rep reuses its site's field without drawing again.
With faults off nothing here runs: a product outside a scope launches
nothing extra.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib

import torch

from repro_torch.core.packed import (PackedConvWeight, PackedWeight,
                                     pack_fused_planes, pack_planes,
                                     repack_codes, repack_conv_codes)

# Key-derivation tags: one disjoint fold_in stream per fault mechanism.
_TAG_WRITE, _TAG_RETAIN, _TAG_DISTURB = 0x57, 0x52, 0x44
_TAG_STUCK0, _TAG_STUCK1, _TAG_SUBFAIL = 0x50, 0x51, 0x5F


@dataclasses.dataclass(frozen=True)
class Key:
    """A position in the reference's key tree: ``path`` is the root
    ``("seed", s)`` (``jax.random.PRNGKey(s)``) followed by steps, each an
    int (``fold_in``), ``("split", n, i)`` (``split(key, n)[i]``) or
    ``("chain", c)`` (``c`` times ``key = split(key)[0]``, the serving
    engines' key threading)."""

    path: tuple

    @classmethod
    def root(cls, seed: int) -> Key:
        return cls((("seed", int(seed)),))

    def fold_in(self, i: int) -> Key:
        return Key(self.path + (int(i),))

    def split(self, n: int, i: int) -> Key:
        return Key(self.path + (("split", int(n), int(i)),))

    def chain(self, c: int) -> Key:
        if not c:
            return self
        last = self.path[-1]
        if isinstance(last, tuple) and last[0] == "chain":
            return Key(self.path[:-1] + (("chain", last[1] + int(c)),))
        return Key(self.path + (("chain", int(c)),))

    def seed64(self) -> int:
        """A 64-bit generator seed that is a function of the path."""
        h = hashlib.blake2b(repr(self.path).encode(), digest_size=8)
        return int.from_bytes(h.digest(), "little")


class TorchDrawer:
    """The default drawer: a ``torch.Generator`` on the draw's device,
    seeded from the key's path for each draw (``Key.seed64``). Draws are
    ``uint8`` 0/1."""

    def __init__(self):
        self._gens: dict = {}

    def bernoulli(self, key: Key, rate: float, shape, device) -> torch.Tensor:
        device = torch.device(device)
        gen = self._gens.get(device)
        if gen is None:
            gen = self._gens[device] = torch.Generator(device=device)
        gen.manual_seed(key.seed64())
        out = torch.empty(tuple(shape), dtype=torch.uint8, device=device)
        return out.bernoulli_(rate, generator=gen)


_DRAWER = TorchDrawer()


@contextlib.contextmanager
def use_drawer(drawer):
    """Route every draw inside the block through ``drawer`` (an object
    with ``bernoulli(key, rate, shape, device)`` returning a 0/1 tensor)."""
    global _DRAWER
    prev, _DRAWER = _DRAWER, drawer
    try:
        yield drawer
    finally:
        _DRAWER = prev


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Device fault rates + mitigation knobs for one deployment.

    Rates are per-bit probabilities; ``subarray_fail_rate`` is per
    (bit-plane, column-group): a failed subarray zeroes its whole extent.
    ``protect_msb`` counts weight planes from the MSB down that are stored
    ``vote_copies``-redundant and majority-voted. ``checksum`` arms the
    col_sums integrity probe; ``spare_cols`` bounds how many flagged
    columns :func:`repair_packed` may remap per subarray.
    """

    write_ber: float = 0.0
    read_disturb_ber: float = 0.0
    retention_ber: float = 0.0
    stuck0_rate: float = 0.0
    stuck1_rate: float = 0.0
    subarray_fail_rate: float = 0.0
    subarray_cols: int = 128          # columns per subarray (Geometry.cols)
    seed: int = 0
    # -- mitigation -----------------------------------------------------
    protect_msb: int = 0
    vote_copies: int = 3
    checksum: bool = False
    spare_cols: int = 0

    @property
    def persistent(self) -> bool:
        """Any programming-time fault mechanism enabled?"""
        return (self.write_ber > 0 or self.retention_ber > 0
                or self.stuck0_rate > 0 or self.stuck1_rate > 0
                or self.subarray_fail_rate > 0)

    @property
    def transient(self) -> bool:
        """Per-read disturb enabled?"""
        return self.read_disturb_ber > 0

    def key(self) -> Key:
        """The root key, ``PRNGKey(seed)`` in the reference; the default
        drawer seeds a ``torch.Generator`` from it (and the path below it)
        at every draw."""
        return Key.root(self.seed)


# ---------------------------------------------------------------------------
# Corruption core: everything on the (bits, K, N) plane decomposition
# ---------------------------------------------------------------------------

def _acc_dtype(bits: int):
    """The type a field of ``bits`` bits is built in: a byte up to 8."""
    return torch.uint8 if bits <= 8 else torch.int32


def _majority(vals: list) -> torch.Tensor:
    """Bitwise majority of an odd number of equal-shape 0/1 planes."""
    n = len(vals)
    if n == 1:
        return vals[0]
    acc = sum(v.to(torch.int32) for v in vals)
    return (acc > n // 2).to(vals[0].dtype)


def _flip(key: Key, rate: float, shape, device) -> torch.Tensor:
    if rate <= 0:
        return torch.zeros(tuple(shape), dtype=torch.uint8, device=device)
    return _DRAWER.bernoulli(key, rate, shape, device).to(torch.uint8)


def _subarray_mask(key: Key, cfg: FaultConfig, k: int, n: int,
                   device) -> torch.Tensor:
    """(K, N) 0/1 mask of cells inside failed subarrays (stuck-at-0)."""
    groups = -(-n // cfg.subarray_cols)
    hit = _flip(key, cfg.subarray_fail_rate, (groups,), device)
    cols = hit.repeat_interleave(cfg.subarray_cols)[:n]
    return cols[None, :].expand(k, n)


def corrupt_codes(codes: torch.Tensor, bits: int, cfg: FaultConfig,
                  key: Key) -> torch.Tensor:
    """Apply every persistent fault mechanism to (K, N) weight codes.

    Per plane ``b``: each stored copy independently picks up write and
    retention flips (XOR: a double flip cancels), then stuck-at and
    dead-subarray cells override what was written; protected planes
    majority-vote their copies. Returns codes of the input's type.
    """
    k, n = codes.shape[-2], codes.shape[-1]
    dev = codes.device
    acc = _acc_dtype(bits)
    src = codes.to(acc)
    out = torch.zeros((k, n), dtype=acc, device=dev)
    for b in range(bits):
        plane = ((src >> b) & 1).to(torch.uint8)
        copies = cfg.vote_copies if b >= bits - cfg.protect_msb else 1
        kb = key.fold_in(b)
        stored = []
        for r in range(copies):
            kr = kb.fold_in(r)
            v = plane ^ _flip(kr.fold_in(_TAG_WRITE), cfg.write_ber, (k, n),
                              dev)
            v ^= _flip(kr.fold_in(_TAG_RETAIN), cfg.retention_ber, (k, n),
                       dev)
            s0 = _flip(kr.fold_in(_TAG_STUCK0), cfg.stuck0_rate, (k, n), dev)
            if cfg.subarray_fail_rate > 0:
                s0 |= _subarray_mask(kr.fold_in(_TAG_SUBFAIL), cfg, k, n, dev)
            s1 = _flip(kr.fold_in(_TAG_STUCK1), cfg.stuck1_rate, (k, n), dev)
            stored.append((v & (1 - s0)) | s1)
        out |= _majority(stored).to(acc) << b
    return out.to(codes.dtype)


def transient_flip_field(shape_kn, bits: int, cfg: FaultConfig, key: Key,
                         device="cpu") -> torch.Tensor:
    """(K, N) XOR field of one read's disturb flips (``uint8`` at <= 8
    bits, int32 above; the reference's values).

    Bit ``b`` of the field is set where plane ``b``'s sensed value flips
    this read. Protected planes sense all copies and vote, so their
    effective flip needs a majority of copies disturbed at once.
    """
    k, n = shape_kn
    acc = _acc_dtype(bits)
    field = torch.zeros((k, n), dtype=acc, device=device)
    for b in range(bits):
        copies = cfg.vote_copies if b >= bits - cfg.protect_msb else 1
        kb = key.fold_in(_TAG_DISTURB).fold_in(b)
        flips = [_flip(kb.fold_in(r), cfg.read_disturb_ber, (k, n), device)
                 for r in range(copies)]
        field |= _majority(flips).to(acc) << b
    return field


# ---------------------------------------------------------------------------
# Rendering one code-space fault field into every packed representation
# ---------------------------------------------------------------------------

def is_rep_stack(p) -> bool:
    """A scan-stacked leaf of the port: a non-empty list of PackedWeights
    (one a rep), the reference's one stacked leaf."""
    return (isinstance(p, list) and bool(p)
            and all(isinstance(v, PackedWeight) for v in p))


def _is_leaf(p) -> bool:
    return isinstance(p, (PackedWeight, PackedConvWeight)) or is_rep_stack(p)


def inject_packed(pw, cfg: FaultConfig, key: Key):
    """Persistent-fault injection at subarray programming time.

    Takes a :class:`PackedWeight` (a (K, N) weight or an (E, K, N) bank),
    a :class:`PackedConvWeight`, or a rep stack (a list of PackedWeights);
    returns the same kind with corrupted codes and the planes (and the
    fused conv layout) re-packed from them through kernel 1, so every
    backend reads the same device state. A rep stack injects rep ``r``
    with ``split(key, R)[r]``, a bank expert ``e`` with
    ``split(key, E)[e]``; ``col_sums`` stay golden.
    """
    if isinstance(pw, PackedConvWeight):
        return repack_conv_codes(
            pw, corrupt_codes(pw.mat.codes, pw.bits, cfg, key))
    if is_rep_stack(pw):
        return [inject_packed(p, cfg, key.split(len(pw), r))
                for r, p in enumerate(pw)]
    if pw.is_bank:
        e = pw.codes.shape[0]
        return repack_codes(pw, torch.stack([
            corrupt_codes(pw.codes[i], pw.bits, cfg, key.split(e, i))
            for i in range(e)]))
    return repack_codes(pw, corrupt_codes(pw.codes, pw.bits, cfg, key))


def inject_tree(tree, cfg: FaultConfig | None, key: Key | None = None):
    """Inject persistent faults into every packed leaf of a param tree.

    Each leaf (a PackedWeight, PackedConvWeight or rep stack) gets its own
    key folded from a depth-first leaf counter (dicts in their order).
    With ``cfg.checksum`` armed the flagged columns are remapped to spares
    (``cfg.spare_cols`` a subarray) and re-programmed from the golden
    tree, the deployment-time test-and-repair pass. Returns ``(tree,
    report)``.
    """
    if cfg is None or not cfg.persistent:
        return tree, {"injected": 0, "bad_cols": 0, "repaired_cols": 0}
    key = cfg.key() if key is None else key
    count = {"i": 0}
    report = {"injected": 0, "bad_cols": 0, "repaired_cols": 0}

    def walk(p):
        if _is_leaf(p):
            leaf_key = key.fold_in(count["i"])
            count["i"] += 1
            bad = inject_packed(p, cfg, leaf_key)
            report["injected"] += 1
            if cfg.checksum:
                bad, n_bad, n_fix = repair_packed(bad, p, cfg.spare_cols,
                                                  cfg.subarray_cols)
                report["bad_cols"] += n_bad
                report["repaired_cols"] += n_fix
            return bad
        if isinstance(p, dict):
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v) for v in p)
        return p

    return walk(tree), report


# ---------------------------------------------------------------------------
# Checksum detection + spare-column repair
# ---------------------------------------------------------------------------

def verify_columns(pw) -> torch.Tensor:
    """Integrity probe: (..., N) bool mask of columns whose stored codes no
    longer sum to the periphery's golden ``col_sums`` (Sw register); a rep
    stack gives (R, ..., N). Byte codes are summed in int32."""
    if isinstance(pw, PackedConvWeight):
        pw = pw.mat
    if is_rep_stack(pw):
        return torch.stack([verify_columns(p) for p in pw])
    return pw.codes.sum(-2, dtype=torch.int32) != pw.col_sums


def _repair_codes(codes, golden_codes, col_sums, spare_cols: int,
                  subarray_cols: int | None = None):
    bad = codes.sum(-2, dtype=torch.int32) != col_sums         # (..., N)
    badi = bad.to(torch.int32)
    if subarray_cols:
        # Spares are per-subarray hardware: a leaf spanning S column groups
        # gets ``spare_cols`` repairs in each group.
        n = badi.shape[-1]
        pad = (-n) % subarray_cols
        grp = torch.nn.functional.pad(badi, (0, pad))
        grp = grp.reshape(*badi.shape[:-1], -1, subarray_cols)
        budget = (torch.cumsum(grp, dim=-1) <= spare_cols).reshape(
            *badi.shape[:-1], -1)[..., :n]
    else:
        budget = torch.cumsum(badi, dim=-1) <= spare_cols
    fix = bad & budget
    repaired = torch.where(fix[..., None, :], golden_codes, codes)
    return repaired, int(bad.sum()), int(fix.sum())


def repair_packed(pw, golden, spare_cols: int,
                  subarray_cols: int | None = None):
    """Remap up to ``spare_cols`` checksum-flagged columns to spares and
    re-program them from the golden weights.

    Returns ``(repaired, n_bad, n_repaired)`` as python ints. With
    ``subarray_cols`` the budget applies per group of that many columns;
    without it the budget is leaf-wide (per rep, per expert). Columns past
    the budget stay faulty. A leaf with nothing to repair comes back as it
    is (its planes would re-pack to the same bits).
    """
    if is_rep_stack(pw):
        out, n_bad, n_fix = [], 0, 0
        for p, g in zip(pw, golden):
            fixed, b, f = repair_packed(p, g, spare_cols, subarray_cols)
            out.append(fixed)
            n_bad, n_fix = n_bad + b, n_fix + f
        return out, n_bad, n_fix
    if isinstance(pw, PackedConvWeight):
        codes, n_bad, n_fix = _repair_codes(
            pw.mat.codes, golden.mat.codes, pw.mat.col_sums, spare_cols,
            subarray_cols)
        return ((repack_conv_codes(pw, codes) if n_fix else pw),
                n_bad, n_fix)
    codes, n_bad, n_fix = _repair_codes(
        pw.codes, golden.codes, pw.col_sums, spare_cols, subarray_cols)
    return (repack_codes(pw, codes) if n_fix else pw), n_bad, n_fix


def repair_tree(tree, golden, spare_cols: int,
                subarray_cols: int | None = None):
    """Checksum-scan every packed leaf against its golden twin and remap
    flagged columns onto spares (per-subarray budget when
    ``subarray_cols`` is given). Returns ``(repaired_tree, {"bad_cols",
    "repaired_cols"})``: the field-service pass a deployment runs when the
    watchdog suspects silent corruption."""
    report = {"bad_cols": 0, "repaired_cols": 0}

    def walk(p, g):
        if _is_leaf(p):
            fixed, n_bad, n_fix = repair_packed(p, g, spare_cols,
                                                subarray_cols)
            report["bad_cols"] += n_bad
            report["repaired_cols"] += n_fix
            return fixed
        if isinstance(p, dict):
            return {k: walk(v, g[k]) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v, gv) for v, gv in zip(p, g))
        return p

    return walk(tree, golden), report


# ---------------------------------------------------------------------------
# Transient read disturb: scoped per decode step or dispatch, keyed per site
# ---------------------------------------------------------------------------
# Model code stays fault-agnostic: the engine opens the scope around a
# decode step (or a vision dispatch), and the bit-serial entry points
# (core.bitserial.int_matmul_prepacked and its bank form,
# kernels.ops.conv2d_bitserial) consult it. Each call takes the next site
# index, whose key is fold_in(scope key, site).

_READ_CFG: FaultConfig | None = None
_READ_KEY: Key | None = None
_READ_SITE = 0
_READ_FIELDS: dict = {}     # site -> {"field": ..., "planes": ..., ...}


@contextlib.contextmanager
def read_disturb_scope(cfg: FaultConfig | None, key: Key):
    """Activate transient read-disturb for the products run inside."""
    global _READ_CFG, _READ_KEY, _READ_SITE, _READ_FIELDS
    if cfg is None or not cfg.transient:
        yield
        return
    prev = (_READ_CFG, _READ_KEY, _READ_SITE, _READ_FIELDS)
    _READ_CFG, _READ_KEY, _READ_SITE, _READ_FIELDS = cfg, key, 0, {}
    try:
        yield
    finally:
        _READ_CFG, _READ_KEY, _READ_SITE, _READ_FIELDS = prev


def read_disturb_active() -> bool:
    return _READ_CFG is not None


def site_mark() -> int | None:
    """The site counter inside an active scope, the sites numbered so far
    (None outside): a scan-stacked layer loop takes it before rep 0 and
    rewinds to it (:func:`site_rewind`) at each rep, so every rep reads
    at the sites the reference's one traced scan body numbers."""
    return _READ_SITE if _READ_CFG is not None else None


def site_rewind(mark: int | None) -> None:
    global _READ_SITE
    if mark is not None and _READ_CFG is not None:
        _READ_SITE = mark


def _site_entry(shape_kn, bits: int, device) -> dict:
    """The next site's cache entry, with its (K, N) flip field drawn (or
    kept from an earlier rep)."""
    global _READ_SITE
    site = _READ_SITE
    _READ_SITE += 1
    entry = _READ_FIELDS.get(site)
    if entry is None or entry["field"].shape != tuple(shape_kn):
        field = transient_flip_field(shape_kn, bits, _READ_CFG,
                                     _READ_KEY.fold_in(site), device)
        entry = _READ_FIELDS[site] = {"field": field}
    return entry


def disturb_packed(pw: PackedWeight, reads: str = "planes") -> PackedWeight:
    """One read's disturbed view of a packed weight (scope active).

    The site's (K, N) flip field is XOR-ed into the form the backend
    reads: ``reads="planes"`` (``cuda``, ``popcount``: the field packed
    through kernel 1) or ``"codes"`` (``int-direct``, ``mxu-plane``); the
    other form is left as it is, as the reference's compiler drops it. An
    (E, K, N) bank takes one field for all its experts. ``col_sums`` stay
    golden (the periphery register is read digitally).
    """
    k, n = pw.codes.shape[-2], pw.codes.shape[-1]
    entry = _site_entry((k, n), pw.bits, pw.codes.device)
    if reads == "codes":
        return dataclasses.replace(
            pw, codes=pw.codes ^ entry["field"].to(pw.codes.dtype))
    mask = entry.get("planes")
    if mask is None:
        mask = pack_planes(entry["field"].to(torch.int32).T.contiguous(),
                           pw.bits)
        pad = pw.planes.shape[-1] - mask.shape[-1]
        if pad:
            mask = torch.nn.functional.pad(mask, (0, pad))
        entry["planes"] = mask
    return dataclasses.replace(pw, planes=pw.planes ^ mask)


def disturb_fused_planes(fused: torch.Tensor, kernel_shape) -> torch.Tensor:
    """One read's disturbed view of a fused conv layout (scope active).

    The field is drawn in im2col code space, the shape the materialized
    path's :func:`disturb_packed` draws at the same site, so the fused
    kernel and the im2col product read the same disturbed device state."""
    kh, kw, c, o = kernel_shape
    bits = fused.shape[1]
    entry = _site_entry((kh * kw * c, o), bits, fused.device)
    mask = entry.get("fused")
    if mask is None:
        mask = entry["fused"] = pack_fused_planes(
            entry["field"].to(torch.int32).reshape(kh, kw, c, o), bits)
    return fused ^ mask


__all__ = ["FaultConfig", "Key", "TorchDrawer", "corrupt_codes",
           "disturb_fused_planes", "disturb_packed", "inject_packed",
           "inject_tree", "is_rep_stack", "read_disturb_active",
           "read_disturb_scope", "repair_packed", "repair_tree",
           "site_mark", "site_rewind", "transient_flip_field",
           "use_drawer", "verify_columns"]
