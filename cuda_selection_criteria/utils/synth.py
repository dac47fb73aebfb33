"""Seeded synthetic sketch banks at collection scale, with planted clusters.

Hashing every k-mer of a 10^7-k-mer genome is far too slow for banks of
10^5 genomes, so registers are drawn from the HLL register law instead:
for a set of n distinct uniform 64-bit hashes and m = 2^p registers,

    P(reg <= k) = (1 - 2^-k / m)^n   (0 <= k <= q),   reg <= q + 1 always,

so reg = max(0, ceil(-log2(m * (1 - u^(1/n))))) for u ~ U(0, 1), clipped
to q + 1. The draw runs on the default device, one row block at a time.

Planted near-duplicate clusters: each cluster has a shared core of s
k-mers and members that add a private fraction f_i * s of their own, so
member registers are max(core, private_i) - exactly the registers of the
union set - and the pair Jaccard is J_ik = 1 / (1 + f_i + f_k). The
default ladder of f straddles tau = 0.9. SuperMinHash buckets follow the
same structure: bucket j of a member is min(core_j, private_ij), the
minima of uniform hashes, so two members' buckets collide with
probability J_ik, as for real SuperMinHash sketches.

Twins are built the same way as two-member clusters whose Jaccard is drawn
uniformly from TWIN_JACCARD around tau. They are not planted pairs: they
are the near-threshold part of the sample that check (c) holds to the
oracle, so that check sees pairs the oracle passes.

check_selection holds an engine's emitted pairs to the exact host oracle
(utils/hostref.PairOracle): every planted pair the oracle passes must be
emitted, every emitted pair must pass, and on sampled other pairs the
oracle's verdict must agree with the engine's.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

# Private-fraction ladder of a cluster's members: pair sums 0.065 ...
# 0.15 put pair Jaccards 1/(1 + f_i + f_k) on both sides of 0.9.
DEFAULT_LADDER = (0.02, 0.045, 0.06, 0.09)
# Jaccard range of the twins (near-duplicate pairs outside the clusters).
TWIN_JACCARD = (0.88, 0.92)


@partial(jax.jit, static_argnames=("p",))
def _law_regs(key, cards, p):
    """(rows, 2^p) uint8 registers drawn from the HLL register law."""
    m = 1 << p
    u = jax.random.uniform(key, (cards.shape[0], m), jnp.float32,
                           minval=np.float32(2.0**-24), maxval=1.0)
    # 1 - u^(1/n) = -expm1(ln(u)/n); the register is the least k with
    # 2^-k / m <= that, i.e. k >= -log2(m * (1 - u^(1/n))).
    tail = -jnp.expm1(jnp.log(u) / cards[:, None].astype(jnp.float32))
    k = jnp.ceil(-jnp.log2(np.float32(m) * tail))
    return jnp.clip(k, 0, 64 - p + 1).astype(jnp.uint8)


def _law_bank(key, cards, p, block=4096):
    """Host (rows, 2^p) uint8 registers for cardinalities `cards`,
    drawn on device `block` rows per dispatch (one compiled shape)."""
    out = np.empty((len(cards), 1 << p), np.uint8)
    for b0 in range(0, len(cards), block):
        c = np.ones(block, np.float32)
        take = min(block, len(cards) - b0)
        c[:take] = cards[b0:b0 + take]
        regs = _law_regs(jax.random.fold_in(key, b0), jnp.asarray(c), p)
        out[b0:b0 + take] = np.asarray(regs)[:take]
    return out


def _min_hashes(rng, cards, m):
    """(rows, m) uint64 minima of card[i] uniform 64-bit hashes."""
    x = -np.log1p(-rng.random((len(cards), m))) / np.asarray(
        cards, np.float64)[:, None]
    return np.minimum(x * 2.0**64, 2.0**64 - 2.0**11).astype(np.uint64)


def _members(key, rng, core, frac, p, m_smh):
    """Registers and SMH buckets of cluster members: member (g, i) is the
    union of core set g (core[g] k-mers) and a private set of
    frac[g, i] * core[g] k-mers. Rows are member-major within a cluster."""
    c = frac.shape[1]
    priv = np.repeat(core, c) * frac.ravel()
    regs = np.maximum(
        np.repeat(_law_bank(jax.random.fold_in(key, 0), core, p), c, axis=0),
        _law_bank(jax.random.fold_in(key, 1), priv, p))
    aux = np.minimum(np.repeat(_min_hashes(rng, core, m_smh), c, axis=0),
                     _min_hashes(rng, priv, m_smh))
    return regs, aux


def synthetic_bank(n, seed=0, p=14, m_smh=32, n_clusters=512,
                   card_range=(1e4, 1e7), ladder=DEFAULT_LADDER,
                   n_twins=None):
    """(bank, planted, twins): a SketchBank of n genomes with smh_a aux
    buckets, the planted within-cluster pairs and the twin pairs, each an
    int64 (P, 2) array of bank row indices.

    Cardinalities are log-uniform over card_range (equal mass per decade:
    viral to bacterial genome sizes). Rows [0, n_clusters * len(ladder))
    are cluster members, the next 2 * n_twins rows are twins (n_twins
    defaults to 2 * n_clusters), the rest are unrelated genomes."""
    from ..models.bank import SketchBank

    c = len(ladder)
    n_twins = 2 * n_clusters if n_twins is None else n_twins
    n_mem = n_clusters * c
    n_rel = n_mem + 2 * n_twins
    if n_rel > n:
        raise ValueError(f"{n_clusters} clusters of {c} and {n_twins} twins "
                         f"need n >= {n_rel}")
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    lo, hi = np.log(card_range[0]), np.log(card_range[1])

    regs = np.empty((n, 1 << p), np.uint8)
    aux = np.empty((n, m_smh), np.uint64)
    core = np.exp(rng.uniform(lo, hi, n_clusters))
    frac = np.tile(np.asarray(ladder, np.float64), (n_clusters, 1))
    regs[:n_mem], aux[:n_mem] = _members(
        jax.random.fold_in(key, 1), rng, core, frac, p, m_smh)
    # a twin pair's Jaccard is 1 / (1 + 2f), f each member's private part
    core = np.exp(rng.uniform(lo, hi, n_twins))
    f = 0.5 * (1.0 / rng.uniform(*TWIN_JACCARD, n_twins) - 1.0)
    regs[n_mem:n_rel], aux[n_mem:n_rel] = _members(
        jax.random.fold_in(key, 2), rng, core, np.stack([f, f], 1), p, m_smh)
    back = np.exp(rng.uniform(lo, hi, n - n_rel))
    regs[n_rel:] = _law_bank(jax.random.fold_in(key, 0), back, p)
    aux[n_rel:] = rng.integers(0, 1 << 63, size=(n - n_rel, m_smh),
                               dtype=np.uint64)

    base = np.arange(n_clusters)[:, None] * c
    iu, ku = np.triu_indices(c, 1)
    planted = np.stack([(base + iu).ravel(), (base + ku).ravel()], 1)
    twins = n_mem + 2 * np.arange(n_twins)[:, None] + np.arange(2)
    bank = SketchBank(names=[f"g{i:07d}" for i in range(n)], regs=regs,
                      p=p, aux_kind="smh", aux=aux, aux_param=m_smh)
    return bank, planted.astype(np.int64), twins.astype(np.int64)


def _oracle(bank, criterion, tau):
    """(oracle, pos): the exact host oracle over the bank in its own row
    order, and each row's position in the ascending-cardinality sort."""
    from .hostref import PairOracle

    order = bank.sorted_by_cardinality()
    pos = np.empty(bank.n, np.int64)
    pos[order] = np.arange(bank.n)
    oracle = PairOracle(
        bank.p, bank.regs, np.trunc(bank.cards), aux=bank.aux,
        aux_param=bank.aux_param, criterion=criterion, tau=tau,
        apply_cb=criterion not in ("baseline", "smh_only"))
    return oracle, pos


def _verdicts(oracle, pos, pairs):
    """{(i, k): jacc} of the pairs the oracle selects; each pair is put in
    the sorted order the cascade assumes (lower-cardinality row first)."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    swap = pos[pairs[:, 0]] > pos[pairs[:, 1]]
    pairs = np.where(swap[:, None], pairs[:, ::-1], pairs)
    return {(i, k): j for i, k, j in oracle.confirm_pairs(map(tuple, pairs))}


def check_selection(bank, results, planted, twins, criterion, tau,
                    n_samples, seed=0):
    """Hold emitted results [(name_i, name_j, jacc)] to the host oracle.

    Returns a dict of counts; raises AssertionError on any disagreement:
      (a) a planted pair the oracle passes is missing (the device screen
          must stay a superset);
      (b) an emitted pair fails the oracle or carries another Jaccard;
      (c) on the twins and n_samples other pairs - half uniform, half
          neighbours in the cardinality sort, which pass the CB gate and
          reach the union - the oracle selects a pair the engine did not
          emit. The oracle must pass some twins: a check that sees no
          passing pair could not catch a screen that drops them."""
    oracle, pos = _oracle(bank, criterion, tau)
    index = {name: i for i, name in enumerate(bank.names)}
    emitted = {}
    for a, b, j in results:
        i, k = index[a], index[b]
        emitted[(i, k) if pos[i] < pos[k] else (k, i)] = j

    want = _verdicts(oracle, pos, planted)
    lost = [pr for pr in want if pr not in emitted]
    if lost:
        raise AssertionError(
            f"planted pairs passing the oracle not emitted: {lost[:5]}")

    got = _verdicts(oracle, pos, list(emitted))
    wrong = [(pr, j) for pr, j in emitted.items() if got.get(pr) != j]
    if wrong:
        raise AssertionError(f"emitted pairs the oracle rejects: {wrong[:5]}")

    rng = np.random.default_rng(seed + 1)
    half = n_samples // 2
    uni = rng.integers(0, bank.n, size=(n_samples - half, 2))
    order = np.argsort(pos)
    s0 = rng.integers(0, bank.n - 1, size=half)
    near = np.stack([order[s0], order[np.minimum(
        s0 + rng.integers(1, 64, size=half), bank.n - 1)]], 1)
    sample = np.concatenate([uni, near])
    sample = sample[sample[:, 0] != sample[:, 1]]
    planted_set = {tuple(x) for x in np.sort(planted, 1).tolist()}
    keep = [tuple(x) not in planted_set for x in np.sort(sample, 1).tolist()]
    sample = np.concatenate([twins, sample[np.asarray(keep, bool)]])
    sel = _verdicts(oracle, pos, sample)
    missed = [pr for pr in sel if pr not in emitted]
    if missed:
        raise AssertionError(
            f"sampled pairs the oracle selects, not emitted: {missed[:5]}")
    twins_pass = len(_verdicts(oracle, pos, twins))
    if len(twins) and not twins_pass:
        raise AssertionError("the oracle passes no twin: check (c) is void")
    return {"planted": len(planted), "planted_pass": len(want),
            "emitted": len(emitted), "sampled": len(sample),
            "sampled_pass": len(sel), "twins": len(twins),
            "twins_pass": twins_pass}
