"""Run the selection pipeline once on one GPU, end to end, and check it.

    python chip_smoke.py [--seed S] [--n N] [--samples K]
    python chip_smoke.py --four-cards [--seed S] [--n N]

Phases (one process, every phase prints one result line; any failure
exits non-zero before the final line):

  1. device      the default JAX device is a GPU; its kind, name and
                 power limit (every later time refers to this card).
  2. build       a seeded gzipped FASTA corpus (64 genomes, 0.5-5 Mbp,
                 near-duplicate clusters from mutation ladders) through
                 cli/build_sketch with --backend device and --backend
                 native: sketch files must be byte-identical.
  3. selection   cli/selection on those sketches for smh_a, hll_a,
                 hll_an, cb and baseline at tau=0.9 (engine auto, which
                 must resolve to the screened engine): output lines must
                 equal the scalar host reference (select_pairs_host).
  4. bank        a synthetic bank of --n genomes at p=14 (registers from
                 the HLL register law, heavy-tailed cardinalities, >= 512
                 planted clusters) through select_pairs for smh_a and cb:
                 planted pairs the oracle passes are emitted, emitted
                 pairs pass the oracle, sampled pairs agree with it. Wall
                 time, pairs/s and the stage split are information.
  5. screen      the compiled screen at p=14 and the engine's tile size,
                 on phase-4 value sets with and without a zero bin, with
                 smh_a and cb gates, against a host numpy reference of
                 S, Z and the certified hit mask.
  6. mle         the device ERTL-MLE of every phase-4 bank row against
                 the host f64 reference, bit for bit.

--four-cards instead runs select_pairs_screened_sharded and
select_pairs_ring on a ("rows",) mesh over four GPUs and the one-card
select_pairs_screened, all on the phase-4 bank (--n genomes) with the
smh_a and cb criteria: the three emitted lists must be identical. No other
phase runs.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Scratch files go to a directory inside the checkout that is removed at
the end.
"""

import argparse
import contextlib
import gzip
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TAU = 0.9
CRITERIA = ("smh_a", "hll_a", "hll_an", "cb", "baseline")
# Mutation ladder of a cluster's members (substitution rate vs the base):
# pair rates r_i + r_k from 0.0007 to 0.003 straddle the k=31 Jaccard of
# 0.9, r ~ 0.00175.
LADDER = (0.0002, 0.0005, 0.001, 0.002)


def _line(phase, **kv):
    print(f"phase {phase}: " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def phase_device(want):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"default JAX device is {devs[0].platform!r}, "
                           "not a GPU")
    if len(devs) < want:
        raise RuntimeError(f"{len(devs)} GPU(s), {want} needed")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    for row in smi.strip().splitlines():
        print(row, flush=True)
    _line(1, platform=devs[0].platform, kind=repr(devs[0].device_kind),
          count=len(devs), jax=jax.__version__)
    return devs


# ---------------------------------------------------------------- phase 2


def _write_fasta(path, seq):
    width = 80
    n = len(seq)
    pad = -n % width
    body = np.frombuffer(seq + b"A" * pad, np.uint8).reshape(-1, width)
    lines = np.concatenate(
        [body, np.full((body.shape[0], 1), ord("\n"), np.uint8)], 1)
    data = lines.tobytes()
    if pad:
        data = data[: -(pad + 1)] + b"\n"
    with gzip.open(path, "wb", compresslevel=1) as fh:
        fh.write(b">" + os.path.basename(path).encode() + b"\n" + data)


def make_corpus(out_dir, seed, n_genomes=64, n_clusters=8,
                lengths=(5e5, 5e6)):
    """Seeded gzipped FASTA corpus: n_clusters clusters of len(LADDER)
    members (a base genome with ladder substitutions) plus singletons,
    lengths log-uniform over `lengths` bp."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lo, hi = np.log(lengths[0]), np.log(lengths[1])
    seqs = []
    for _ in range(n_clusters):
        length = int(np.exp(rng.uniform(lo, hi)))
        base = rng.integers(0, 4, length).astype(np.uint8)
        for rate in LADDER:
            s = base.copy()
            hit = np.nonzero(rng.random(length) < rate)[0]
            s[hit] = (s[hit] + rng.integers(1, 4, hit.size)) % 4
            seqs.append(s)
    while len(seqs) < n_genomes:
        length = int(np.exp(rng.uniform(lo, hi)))
        seqs.append(rng.integers(0, 4, length).astype(np.uint8))
    paths = []
    for i, s in enumerate(seqs):
        path = os.path.join(out_dir, f"g{i:02d}.fna.gz")
        _write_fasta(path, acgt[s].tobytes())
        paths.append(path)
    return paths, sum(len(s) for s in seqs)


def _list_file(paths, path):
    with open(path, "w") as fh:
        fh.write("\n".join(paths) + "\n")
    return path


def phase_build(work, seed, **corpus):
    from cuda_selection_criteria.cli import build_sketch

    dev_dir = os.path.join(work, "device")
    nat_dir = os.path.join(work, "native")
    os.makedirs(dev_dir)
    os.makedirs(nat_dir)
    t0 = time.perf_counter()
    dev_paths, n_bases = make_corpus(dev_dir, seed, **corpus)
    corpus_secs = time.perf_counter() - t0
    nat_paths = []
    for p in dev_paths:
        q = os.path.join(nat_dir, os.path.basename(p))
        shutil.copyfile(p, q)
        nat_paths.append(q)
    native = os.path.join(ROOT, "cuda_selection_criteria", "native")
    make = subprocess.run(["make", "-C", native, "-s"], capture_output=True,
                          text=True, timeout=300)
    if make.returncode or not os.path.exists(
            os.path.join(native, "libfastx.so")):
        raise RuntimeError(f"make could not build libfastx.so: "
                           f"{make.stderr[-2000:]}")
    dev_list = _list_file(dev_paths, os.path.join(work, "device.txt"))
    nat_list = _list_file(nat_paths, os.path.join(work, "native.txt"))
    secs = {}
    for crit, suffixes in (("smh_a", (".hll", ".smh32")),
                           ("hll_a", (".hll", ".hll_8"))):
        for backend, lst in (("device", dev_list), ("native", nat_list)):
            t0 = time.perf_counter()
            build_sketch.main(["-l", lst, "-c", crit, "--backend", backend])
            secs[f"{crit}_{backend}"] = round(time.perf_counter() - t0, 3)
        for d, n in zip(dev_paths, nat_paths):
            for suf in suffixes:
                with open(d + suf, "rb") as a, open(n + suf, "rb") as b:
                    if a.read() != b.read():
                        raise AssertionError(
                            f"{os.path.basename(d)}{suf}: device and native "
                            "sketch files differ")
    _line(2, genomes=len(dev_paths), mbases=round(n_bases / 1e6, 1),
          files_identical=2 * len(dev_paths) * 2, corpus_secs=round(
              corpus_secs, 2), **{f"{k}_secs": v for k, v in secs.items()})
    return dev_paths, dev_list


# ---------------------------------------------------------------- phase 3


def phase_selection(paths, list_file):
    from cuda_selection_criteria.cli import selection
    from cuda_selection_criteria.models import SketchBank
    from cuda_selection_criteria.parallel.selection import (
        SelectionParams, format_results, resolve_engine)
    from cuda_selection_criteria.utils.hostref import select_pairs_host

    counts = {}
    for crit in CRITERIA:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            selection.main(["-l", list_file, "-h", str(TAU), "-c", crit])
        secs = time.perf_counter() - t0
        got = out.getvalue().splitlines()
        load = crit if crit in ("smh_a", "hll_a", "hll_an") else None
        bank = SketchBank.from_sketch_files(paths, criterion=load)
        engine = resolve_engine(bank, SelectionParams(tau=TAU,
                                                      criterion=crit))
        if engine != "screened":
            raise AssertionError(f"{crit}: engine auto resolved to "
                                 f"{engine!r}, not 'screened'")
        want = format_results(select_pairs_host(
            bank, TAU, crit, apply_cb=crit != "baseline"))
        if got != want:
            raise AssertionError(f"{crit}: CLI lines differ from the host "
                                 f"reference:\n{got}\nvs\n{want}")
        counts[crit] = f"{len(got)}pairs/{secs:.2f}s"
    _line(3, engine="screened", **counts)


# ---------------------------------------------------------------- phase 4


def phase_bank(n, seed, samples):
    from cuda_selection_criteria.parallel.selection import (
        SelectionParams, resolve_engine, select_pairs)
    from cuda_selection_criteria.utils import synth

    t0 = time.perf_counter()
    bank, planted, twins = synth.synthetic_bank(n, seed=seed)
    setup = time.perf_counter() - t0
    pairs = n * (n - 1) // 2
    print(f"bank: n={n} p={bank.p} register_bytes={bank.regs.nbytes} "
          f"planted_pairs={len(planted)} twin_pairs={len(twins)} "
          f"setup_secs={setup:.2f}", flush=True)
    results = {}
    for crit in ("smh_a", "cb"):
        params = SelectionParams(tau=TAU, criterion=crit)
        engine = resolve_engine(bank, params)
        if engine != "screened":
            raise AssertionError(f"{crit}: engine {engine!r}")
        walls = []
        for _ in range(2):  # cold (compiles), then warm
            stats = {}
            t0 = time.perf_counter()
            res = select_pairs(bank, params, stats=stats)
            walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        chk = synth.check_selection(bank, res, planted, twins, crit, TAU,
                                    samples, seed=seed)
        split = {k: (round(v, 3) if isinstance(v, float) else v)
                 for k, v in stats.items()}
        print(f"bank {crit}: stages {json.dumps(split)} "
              f"compile_secs={walls[0] - walls[1]:.3f}", flush=True)
        _line(4, criterion=crit, engine=engine, wall_secs=round(walls[1], 3),
              cold_wall_secs=round(walls[0], 3),
              pairs_per_sec=f"{pairs / walls[1]:.4e}",
              check_secs=round(time.perf_counter() - t0, 2),
              **{k: v for k, v in chk.items()})
        results[crit] = res
    return bank


# ---------------------------------------------------------------- phase 5


def _dot_precisions(fn, *args):
    """(lhs dtype, rhs dtype, preferred type, precision) of every
    dot_general in fn's jaxpr."""
    import jax

    found = set()

    def walk(jaxpr):
        for eq in jaxpr.eqns:
            if eq.primitive.name == "dot_general":
                found.add((str(eq.invars[0].aval.dtype),
                           str(eq.invars[1].aval.dtype),
                           str(eq.params.get("preferred_element_type")),
                           str(eq.params.get("precision"))))
            for v in eq.params.values():
                inner = getattr(v, "jaxpr", None)
                if inner is not None:
                    walk(getattr(inner, "jaxpr", inner))
    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return sorted(found)


def _host_s_z(a, b, vtop):
    """Host S (f64-exact, rounded to f32) and Z for rows a x cols b, with
    registers above vtop counted as vtop (the truncated telescope)."""
    w = np.ldexp(1.0, -np.arange(256, dtype=np.int64))
    s = np.empty((len(a), len(b)), np.float32)
    z = np.empty((len(a), len(b)), np.float32)
    for i, row in enumerate(a):
        mx = np.minimum(np.maximum(row[None, :], b), vtop)
        s[i] = w[mx].sum(1)
        z[i] = (mx == 0).sum(1)
    return s, z


def phase_screen(bank):
    import jax
    import jax.numpy as jnp

    from cuda_selection_criteria.ops import criteria, screen
    from cuda_selection_criteria.parallel import screened

    p = bank.p
    m = np.float32(1 << p)
    ti = screened.auto_tile(bank.n)
    order = bank.sorted_by_cardinality()
    e_all = np.trunc(bank.cards[order]).astype(np.float32)
    n_rows_b, n_bands = criteria.smh_band_params(bank.aux_param, TAU)
    tau = criteria.effective_tau(TAU)
    tau_scr = np.float32(screened.screen_tau(tau))
    tau_cb = np.float32(tau * (1.0 - 1e-5))
    host_rows = 24  # host reference rows per tile (all ti columns)
    report = {}
    lowest = bank.regs.min(1)[order]
    for label, pick in (("zero_bin", lowest == 0), ("no_zero_bin",
                                                    lowest > 0)):
        sel = order[pick][: 4 * ti]
        if len(sel) < 2 * ti:
            raise AssertionError(f"{label}: only {len(sel)} rows")
        sel = sel[: (len(sel) // ti) * ti]
        regs = bank.regs[sel]
        e = np.trunc(bank.cards[sel]).astype(np.float32)
        fp = screened.band_fingerprints_np(bank.aux[sel], n_rows_b, n_bands)
        values = screen.truncate_values(screen.bank_values(regs),
                                        float(e_all.max()), p)
        if (0 in values) != (label == "zero_bin"):
            raise AssertionError(f"{label}: value set {values}")
        nt = len(sel) // ti
        rows = np.array([0, 0, nt - 2], np.int32)
        cols = np.array([0, 1, nt - 1], np.int32)
        d_regs = jnp.asarray(regs)
        s, z = screen.screen_s_z(d_regs, jnp.asarray(rows), jnp.asarray(cols),
                                 p, values, ti=ti, tj=ti)
        s = np.asarray(s)
        z = None if z is None else np.asarray(z)
        dots = _dot_precisions(
            lambda r: screen.screen_s_z(r, jnp.asarray(rows),
                                        jnp.asarray(cols), p, values,
                                        ti=ti, tj=ti), d_regs)
        s_err = 0.0
        for t, (r, c) in enumerate(zip(rows, cols)):
            a = regs[r * ti: r * ti + host_rows]
            b = regs[c * ti: (c + 1) * ti]
            hs, hz = _host_s_z(a, b, values[-1])
            s_err = max(s_err, float(np.max(np.abs(s[t, :host_rows] - hs)
                                            / hs)))
            if not np.array_equal(s[t, :host_rows], hs):
                raise AssertionError(f"{label} tile {t}: S differs from the "
                                     f"host sum (max rel {s_err:.3e})")
            if z is not None and not np.array_equal(z[t, :host_rows], hz):
                raise AssertionError(f"{label} tile {t}: Z differs")
            if z is None and hz.any():
                raise AssertionError(f"{label}: zero registers, no Z")
        for gate, use_smh in (("smh_a", True), ("cb", False)):
            h = screened._screen_post(
                jnp.asarray(s), None if z is None else jnp.asarray(z),
                jnp.asarray(e), jnp.asarray(fp), jnp.asarray(rows * ti),
                jnp.asarray(cols * ti), jnp.int32(len(sel)),
                jnp.float32(tau_scr), jnp.float32(tau_cb), p, n_bands, ti,
                ti, True, use_smh)
            h = np.asarray(h)
            cnt = np.asarray(screened._screen_chunk(
                d_regs, jnp.asarray(rows), jnp.asarray(cols),
                jnp.asarray(e), jnp.asarray(fp), jnp.int32(len(sel)),
                jnp.float32(tau_scr), jnp.float32(tau_cb), p, values, ti,
                n_bands, True, use_smh)[1])
            if not np.array_equal(cnt, h.sum((1, 2))):
                raise AssertionError(f"{label}/{gate}: per-tile counts "
                                     f"{cnt} vs mask sums {h.sum((1, 2))}")
            # host certificate and gates, numpy f32 without contraction
            ii = (rows * ti)[:, None] + np.arange(ti)[None, :]
            jj = (cols * ti)[:, None] + np.arange(ti)[None, :]
            ea, eb = e[ii][:, :, None], e[jj][:, None, :]
            zz = np.zeros_like(s) if z is None else z
            lhs = (np.float32(3.0) * s - zz) * (ea + eb)
            rhs = np.float32(2.0) * m * (m - zz) * (np.float32(1.0) + tau_scr)
            host = lhs >= rhs
            host &= (ii[:, :, None] < jj[:, None, :]) & (eb > 0)
            host &= ea >= tau_cb * eb
            if use_smh:
                band = (fp[ii][:, :, None, :] == fp[jj][:, None, :, :])
                host &= band.any(-1)
            diff = h != host
            close = np.abs(lhs - rhs) < 1e-5 * np.abs(rhs)
            if (diff & ~close).any():
                raise AssertionError(f"{label}/{gate}: hit masks differ "
                                     f"beyond the 1e-5 band")
            report[f"{label}_{gate}_hits"] = int(h.sum())
            report[f"{label}_{gate}_borderline"] = int(diff.sum())
        report[f"{label}_values"] = len(values)
        report[f"{label}_s_maxrel"] = f"{s_err:.1e}"
    print("screen dots (lhs, rhs, preferred, precision): "
          f"{dots}; weighted sum f64-exact, rounded once to f32",
          flush=True)
    _line(5, ti=ti, host_rows_per_tile=host_rows, **report)


# ---------------------------------------------------------------- phase 6


def phase_mle(bank):
    from cuda_selection_criteria.utils.hostref import ertl_mle_batch

    t0 = time.perf_counter()
    hist = np.empty((bank.n, 64), np.int64)
    block = 4096
    for b0 in range(0, bank.n, block):
        r = bank.regs[b0:b0 + block].astype(np.int32)
        r += (np.arange(len(r), dtype=np.int32) * 64)[:, None]
        hist[b0:b0 + block] = np.bincount(
            r.ravel(), minlength=len(r) * 64).reshape(len(r), 64)
    host = ertl_mle_batch(hist, bank.p)
    same = host == bank.cards
    if not same.all():
        bad = [(int(i), bank.cards[i], host[i])
               for i in np.nonzero(~same)[0][:5]]
        raise AssertionError(f"device MLE differs from host on "
                             f"{int((~same).sum())} rows, e.g. {bad}")
    _line(6, rows=bank.n, bit_identical=int(same.sum()),
          host_secs=round(time.perf_counter() - t0, 2))


# ---------------------------------------------------------------- 4 cards


def phase_four_cards(n, seed):
    import jax
    from jax.sharding import Mesh

    from cuda_selection_criteria.parallel.ring import select_pairs_ring
    from cuda_selection_criteria.parallel.screened import (
        select_pairs_screened, select_pairs_screened_sharded)
    from cuda_selection_criteria.parallel.selection import SelectionParams
    from cuda_selection_criteria.utils import synth

    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("rows",))
    bank, _, _ = synth.synthetic_bank(n, seed=seed)
    for crit in ("smh_a", "cb"):
        params = SelectionParams(tau=TAU, criterion=crit)
        walls, outs = {}, {}
        for name, fn in (
                ("sharded", lambda: select_pairs_screened_sharded(
                    bank, params, mesh=mesh)),
                ("ring", lambda: select_pairs_ring(bank, params, mesh=mesh)),
                ("one_card", lambda: select_pairs_screened(bank, params))):
            t0 = time.perf_counter()
            outs[name] = fn()
            walls[name] = round(time.perf_counter() - t0, 2)
        if not (outs["sharded"] == outs["ring"] == outs["one_card"]):
            raise AssertionError(
                f"{crit}: emitted lists differ: " + ", ".join(
                    f"{k}={len(v)}" for k, v in outs.items()))
        _line("4c", criterion=crit, n=n, emitted=len(outs["ring"]),
              identical=True,
              **{f"{k}_wall_secs": v for k, v in walls.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=262144,
                    help="genomes in the synthetic bank (phase 4)")
    ap.add_argument("--samples", type=int, default=2_000_000,
                    help="non-planted pairs checked against the oracle")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card engines on four GPUs")
    args = ap.parse_args(argv)

    import jax

    from cuda_selection_criteria import enable_compile_cache

    want = 4 if args.four_cards else 1
    devs = phase_device(want)
    enable_compile_cache()
    if args.four_cards:
        phase_four_cards(args.n, args.seed)
        count = 4
    else:
        os.makedirs(os.path.join(ROOT, ".smoke"), exist_ok=True)
        work = tempfile.mkdtemp(dir=os.path.join(ROOT, ".smoke"))
        try:
            paths, list_file = phase_build(work, args.seed)
            phase_selection(paths, list_file)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        bank = phase_bank(args.n, args.seed, args.samples)
        phase_screen(bank)
        phase_mle(bank)
        count = len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr, flush=True)
        sys.exit(1)
