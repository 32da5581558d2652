#!/usr/bin/env python3
"""Smoke run of MindTheGap `find` and `fill` on an NVIDIA GPU, checked
against the host oracles.

Deployment: bacterial-genome resequencing, MindTheGap's own use case. A
seeded random reference of 2^22 bases (E. coli scale); a diploid donor that
carries homozygous and heterozygous insertions, SNPs and deletions; paired
150 bp reads at 30x with substitution errors at e = 0.001 (the reference
tool's simulation recipe). Everything is generated from --seed into a
scratch directory.

Phases, all in this one process (`cli.main` is called in-process for every
run, since a second JAX process could not open the card):

  1. environment: devices, card name and power limit, JAX version, compile
     cache, native libraries (each must load);
  2. find k=31 with -count-engine device (every other option at its
     default) against the host oracle (-count-engine host -scan-engine
     host): identical .breakpoints, VCF and solid k-mer set;
  3. fill -bkpt on that graph with -fill-engine device, native and host:
     identical .insertions.fasta and .insertions.vcf;
  4. k=63 on a 2^20-base deployment: find -scan-engine device and fill
     -fill-engine device against the host engines;
  5. wall time of each phase, each run's -profile breakdown and the time
     JAX spent compiling in it (its own compile timers).

Equality is exact: no device step on this path computes in floating point.
Any exception or mismatch exits non-zero. The last line of standard output
is one JSON object naming the device.

    python chip_smoke.py                 # one card
    python chip_smoke.py --four-cards    # only the multi-device paths, mesh of 4
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

READ_LEN = 150
COVERAGE = 30
ERROR_RATE = 1e-3
FRAGMENT_MEAN, FRAGMENT_SD = 400, 40
CHROM = "chr1"
_BASES = np.frombuffer(b"ACGT", np.uint8)  # complement of code c is 3 - c

# the fill VCF header echoes the graph path (##SAMPLE), the output prefix
# (##REF) and the date; find's echoes the inputs and the date
_PATH_OR_DATE_HEADERS = ("##filedate", "##SAMPLE", "##REF")


class SmokeFailure(Exception):
    pass


# ---------------------------------------------------------------------------
# the deployment: reference, diploid donor, paired reads with errors
# ---------------------------------------------------------------------------
def _write_fasta(path, name, codes, width=80):
    seq = _BASES[codes].tobytes()
    with open(path, "wb") as f:
        f.write(b">%s\n" % name.encode())
        f.write(b"\n".join(seq[i : i + width] for i in range(0, len(seq), width)) + b"\n")


def _apply(ref, edits):
    """One haplotype: ref with (pos, kind, codes) edits applied left to right."""
    parts, cur = [], 0
    for pos, kind, codes in edits:
        parts.append(ref[cur:pos])
        if kind == "ins":
            parts.append(codes)
            cur = pos
        elif kind == "snp":
            parts.append(codes)
            cur = pos + 1
        else:  # del: codes are the deleted reference bases
            cur = pos + codes.size
    parts.append(ref[cur:])
    return np.concatenate(parts)


def _read_records(fh, ids, mate, reads):
    """FASTA records `>p<id>/<mate>` for u8 code rows, written in one block."""
    n = reads.shape[0]
    digits = (ids[:, None] // 10 ** np.arange(9, -1, -1)) % 10 + ord("0")
    head = np.empty((n, 14), np.uint8)
    head[:, 0], head[:, 1] = ord(">"), ord("p")
    head[:, 2:12] = digits
    head[:, 12], head[:, 13] = ord("/"), ord(str(mate))
    nl = np.full((n, 1), ord("\n"), np.uint8)
    fh.write(np.concatenate([head, nl, _BASES[reads], nl], axis=1).tobytes())


def make_deployment(work: str, genome_len: int, seed: int) -> dict:
    """Reference + reads of the resequencing deployment, made from `seed`.

    Per Mbase the donor carries 4 homozygous and 4 heterozygous insertions
    (50-300 bp), 10 SNPs and 4 deletions (1-30 bp), one per equal segment of
    the reference, away from the segment ends. Half the reads come from each
    haplotype; the heterozygous insertions are on the second one only."""
    rng = np.random.default_rng(seed)
    os.makedirs(work, exist_ok=True)
    ref = rng.integers(0, 4, genome_len, dtype=np.uint8)
    per_mb = genome_len / 1e6
    kinds = (
        ["hom"] * max(1, round(4 * per_mb)) + ["het"] * max(1, round(4 * per_mb))
        + ["snp"] * max(1, round(10 * per_mb)) + ["del"] * max(1, round(4 * per_mb))
    )
    rng.shuffle(kinds)
    seg = genome_len // len(kinds)
    hom_edits, het_edits, planted = [], [], []
    for i, kind in enumerate(kinds):
        pos = i * seg + seg // 4 + int(rng.integers(seg // 2))
        if kind in ("hom", "het"):
            ins = rng.integers(0, 4, int(rng.integers(50, 301)), dtype=np.uint8)
            (hom_edits if kind == "hom" else het_edits).append((pos, "ins", ins))
            planted.append((kind, pos, ins))
        elif kind == "snp":
            hom_edits.append((pos, "snp", (ref[pos : pos + 1] + rng.integers(1, 4)) % 4))
        else:
            hom_edits.append((pos, "del", ref[pos : pos + int(rng.integers(1, 31))]))
    haps = [
        _apply(ref, hom_edits),
        _apply(ref, sorted(hom_edits + het_edits, key=lambda e: e[0])),
    ]

    paths = {
        "ref": os.path.join(work, "reference.fasta"),
        "r1": os.path.join(work, "reads_1.fasta"),
        "r2": os.path.join(work, "reads_2.fasta"),
    }
    _write_fasta(paths["ref"], CHROM, ref)
    cols = np.arange(READ_LEN)
    next_id = 0
    with open(paths["r1"], "wb") as f1, open(paths["r2"], "wb") as f2:
        for hap in haps:
            n_pairs = int(COVERAGE * hap.size / (2 * READ_LEN * len(haps)))
            for c0 in range(0, n_pairs, 1 << 16):
                m = min(1 << 16, n_pairs - c0)
                frag = np.clip(
                    rng.normal(FRAGMENT_MEAN, FRAGMENT_SD, m).astype(np.int64),
                    READ_LEN, hap.size,
                )
                start = rng.integers(0, hap.size - frag + 1)
                a = hap[start[:, None] + cols]
                b = 3 - hap[(start + frag - READ_LEN)[:, None] + cols][:, ::-1]
                flip = rng.random(m) < 0.5  # fragment from the other strand
                a[flip], b[flip] = b[flip], a[flip].copy()
                for r in (a, b):
                    err = rng.random(r.shape) < ERROR_RATE
                    r[err] = (r[err] + rng.integers(1, 4, int(err.sum()))) % 4
                ids = np.arange(next_id, next_id + m)
                _read_records(f1, ids, 1, a)
                _read_records(f2, ids, 2, b)
                next_id += m
    return {
        "ref": paths["ref"],
        "reads": paths["r1"] + "," + paths["r2"],
        "genome_len": genome_len,
        "n_pairs": next_id,
        "planted": planted,
    }


# ---------------------------------------------------------------------------
# running the CLI and comparing artifacts
# ---------------------------------------------------------------------------
# JAX's own compile timers, summed per CLI run: backend compile (a
# persistent-cache fetch included) and tracing + lowering to MLIR
_COMPILE_EVENTS = {
    "/jax/core/compile/backend_compile_duration": "compile",
    "/jax/core/compile/jaxpr_trace_duration": "trace+lower",
    "/jax/core/compile/jaxpr_to_mlir_module_duration": "trace+lower",
}
_jit_secs = {"compile": 0.0, "trace+lower": 0.0, "programs": 0}
_listening = []


def _on_duration(event, secs, **_kw):
    kind = _COMPILE_EVENTS.get(event)
    if kind is not None:
        _jit_secs[kind] += secs
        _jit_secs["programs"] += kind == "compile"


def run_cli(args: list[str]):
    """cli.main in this process; returns (seconds, report), the report
    ending in a line of the JAX compile time the run spent. Raises on
    rc != 0."""
    import jax

    from mindthegap_tpu import cli

    if not _listening:
        jax.monitoring.register_event_duration_secs_listener(_on_duration)
        _listening.append(True)
    before = dict(_jit_secs)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise SmokeFailure(f"MindTheGap {' '.join(args)} exited {rc}:\n{buf.getvalue()}")
    d = {k: _jit_secs[k] - before[k] for k in _jit_secs}
    jit = (f"jit: {d['programs']} programs, compile {d['compile']:.2f} s,"
           f" trace+lower {d['trace+lower']:.2f} s")
    return dt, buf.getvalue() + jit + "\n"


def profile_lines(report: str) -> list[str]:
    """The -profile breakdown of a result report, as `phase: seconds`."""
    lines = report.splitlines()
    try:
        i = next(j for j, s in enumerate(lines) if s.strip().startswith("Per-phase timings"))
    except StopIteration:
        return []
    out = []
    for s in lines[i + 1 :]:
        if not s.startswith(" " * 8):
            break
        out.append(re.sub(r"\s+:", ":", s.strip()))
    return out


def breakdown(report: str) -> str:
    """The -profile phases and the JAX compile line of a run_cli report."""
    return "; ".join(profile_lines(report) + [s for s in report.splitlines() if s.startswith("jit: ")])


def _vcf_body(path):
    with open(path) as f:
        return [s for s in f if not s.startswith(_PATH_OR_DATE_HEADERS)]


def _same_bytes(a, b, what):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            raise SmokeFailure(f"{what}: {a} differs from {b}")


def _same_vcf(a, b, what):
    if _vcf_body(a) != _vcf_body(b):
        raise SmokeFailure(f"{what}: {a} differs from {b} (date/path headers excluded)")


def _same_graph(a, b):
    from mindthegap_tpu.graph import dbg

    ga, gb = dbg.Graph.load(a), dbg.Graph.load(b)
    if not (
        ga.k == gb.k and ga.info == gb.info
        and np.array_equal(ga.solid.keys, gb.solid.keys)
        and np.array_equal(ga.solid.counts, gb.solid.counts)
    ):
        raise SmokeFailure(f"solid k-mer sets differ: {a} vs {b}")
    return len(ga.solid)


def planted_found(dep: dict, breakpoints: str, tol: int = 10) -> dict:
    """How many planted insertions have a breakpoint within `tol` bases."""
    pos = []
    with open(breakpoints) as f:
        for line in f:
            m = re.match(r">bkpt\d+_\S+?_pos_(\d+)_fuzzy_\d+_(HOM|HET) .*left_kmer", line)
            if m:
                pos.append(int(m.group(1)))
    pos = np.sort(np.asarray(pos, np.int64))
    found = {"hom": [0, 0], "het": [0, 0]}
    for kind, p, _ins in dep["planted"]:
        found[kind][1] += 1
        j = np.searchsorted(pos, p - tol)
        found[kind][0] += int(j < pos.size and pos[j] <= p + tol)
    return found


def find_vs_oracle(dep, work, k, device_args, *, reuse_graph=False, log=print):
    """find with `device_args` against the host oracle (-count-engine host
    -scan-engine host) on the same inputs; the device run must take the
    fused device scan feed (`scan+replay (fused)`). With reuse_graph the device run
    loads the oracle's graph (-graph) instead of counting the reads again.
    Returns (graph of the device run, its breakpoints, {run: seconds})."""
    common = ["-ref", dep["ref"], "-kmer-size", str(k), "-verbose", "0", "-profile"]
    oracle = os.path.join(work, f"find_k{k}_host")
    dev = os.path.join(work, f"find_k{k}_dev")
    times = {}
    t, rep = run_cli(["find", "-in", dep["reads"], *common, "-out", oracle,
                      "-count-engine", "host", "-scan-engine", "host"])
    times[f"find k={k} host oracle"] = t
    log(f"find k={k} host oracle: {t:.2f} s; " + breakdown(rep))
    src = ["-graph", oracle + ".h5"] if reuse_graph else ["-in", dep["reads"]]
    t, rep = run_cli(["find", *src, *common, "-out", dev, *device_args])
    times[f"find k={k} {' '.join(device_args)}"] = t
    log(f"find k={k} {' '.join(device_args)}: {t:.2f} s; " + breakdown(rep))
    if not any(s.startswith("scan+replay (fused)") for s in profile_lines(rep)):
        raise SmokeFailure(f"find {' '.join(device_args)} did not run the fused scan feed:\n{rep}")
    _same_bytes(dev + ".breakpoints", oracle + ".breakpoints", f"find k={k} .breakpoints")
    _same_vcf(dev + ".othervariants.vcf", oracle + ".othervariants.vcf", f"find k={k} VCF")
    n_solid = _same_graph(dev + ".h5", oracle + ".h5") if not reuse_graph else None
    found = planted_found(dep, dev + ".breakpoints")
    log(f"find k={k}: artifacts identical to the host oracle"
        + (f" ({n_solid} solid k-mers)" if n_solid is not None else "")
        + f"; planted insertions found: hom {found['hom'][0]}/{found['hom'][1]},"
        f" het {found['het'][0]}/{found['het'][1]}")
    if found["hom"][0] + found["het"][0] == 0:
        raise SmokeFailure(f"find k={k} found none of the planted insertions")
    return (oracle if reuse_graph else dev) + ".h5", dev + ".breakpoints", times


def fill_engines_agree(graph, bkpt, work, k, engines, log=print):
    """fill -bkpt on find's graph and breakpoints with each engine; the
    .insertions.fasta and .insertions.vcf must be identical across them."""
    times, outs = {}, []
    for eng in engines:
        out = os.path.join(work, f"fill_k{k}_{eng}")
        t, rep = run_cli(["fill", "-graph", graph, "-bkpt", bkpt, "-out", out,
                          "-fill-engine", eng, "-verbose", "0", "-profile"])
        times[f"fill k={k} -fill-engine {eng}"] = t
        log(f"fill k={k} -fill-engine {eng}: {t:.2f} s; " + breakdown(rep))
        outs.append(out)
    for eng, out in zip(engines[1:], outs[1:]):
        _same_bytes(out + ".insertions.fasta", outs[0] + ".insertions.fasta",
                    f"fill k={k} {eng} vs {engines[0]} .insertions.fasta")
        _same_vcf(out + ".insertions.vcf", outs[0] + ".insertions.vcf",
                  f"fill k={k} {eng} vs {engines[0]} .insertions.vcf")
    with open(outs[0] + ".insertions.fasta") as f:
        n_ins = sum(1 for s in f if s.startswith(">"))
    log(f"fill k={k}: {' / '.join(engines)} identical ({n_ins} insertion sequences)")
    return times


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def check_environment(log=print) -> None:
    """Phase 1: what runs here. Every native library must load: each one
    has a slower Python fallback that would otherwise hide its absence."""
    import jax

    from mindthegap_tpu.fill import traversal_native
    from mindthegap_tpu.find import native_scan
    from mindthegap_tpu.io import cbank
    from mindthegap_tpu.ops import extmap, kmers
    from mindthegap_tpu.utils import native_build
    from mindthegap_tpu.utils.compile_cache import enable_compile_cache

    devs = jax.devices()
    log(f"jax {jax.__version__}; devices: {len(devs)} x {devs[0].platform} {devs[0].device_kind}")
    log(f"card: {_nvidia_smi()}")
    log(f"compile cache: {enable_compile_cache()}")
    libs = {
        "automaton (native/automaton.cpp)": native_scan.available(),
        "traversal engine (native/traversal.cpp)": traversal_native.available(),
        "tables (native/tables.cpp)": extmap._load_native() is not None,
        "fastx parser (native/fastx.cpp, zlib)": cbank.available(),
        "k-mer extraction (native/kmers.cpp)": kmers._load_native() is not None,
    }
    for name, ok in libs.items():
        log(f"native {name}: {'loaded' if ok else 'FAILED'}")
    if not all(libs.values()):
        raise SmokeFailure("native libraries failed to build or load:\n"
                           + "\n".join(f"{s}:\n{e}" for s, e in native_build.errors.items()))


def one_card(work, seed, log=print) -> dict:
    """Phases 2-4."""
    times = {}
    t0 = time.perf_counter()
    dep = make_deployment(os.path.join(work, "k31"), 1 << 22, seed)
    times["generate 2^22-base deployment"] = time.perf_counter() - t0
    log(f"deployment: {dep['genome_len']} bases, {dep['n_pairs']} read pairs, "
        f"{len(dep['planted'])} planted insertions")
    graph, bkpt, t = find_vs_oracle(dep, work, 31, ["-count-engine", "device"], log=log)
    times.update(t)
    times.update(fill_engines_agree(graph, bkpt, work, 31, ["device", "native", "host"], log=log))

    t0 = time.perf_counter()
    dep63 = make_deployment(os.path.join(work, "k63"), 1 << 20, seed + 1)
    times["generate 2^20-base deployment"] = time.perf_counter() - t0
    graph, bkpt, t = find_vs_oracle(dep63, work, 63, ["-scan-engine", "device"],
                                    reuse_graph=True, log=log)
    times.update(t)
    times.update(fill_engines_agree(graph, bkpt, work, 63, ["device", "host"], log=log))
    return times


def four_cards(work, seed, log2_len=22, log=print) -> dict:
    """The multi-device paths on a mesh of 4, each against host-engine
    artifacts of the same inputs."""
    times = {}
    t0 = time.perf_counter()
    dep = make_deployment(os.path.join(work, "k31"), 1 << log2_len, seed)
    times[f"generate 2^{log2_len}-base deployment"] = time.perf_counter() - t0
    _graph, _bkpt, t = find_vs_oracle(
        dep, work, 31, ["-count-engine", "sharded", "-scan-engine", "sharded"], log=log)
    times.update(t)
    # a 1 MB scan-map budget forces the replicated map over budget: auto
    # routes membership through the sharded-mem all_to_all engine
    oracle = os.path.join(work, "find_k31_host")
    mem = os.path.join(work, "find_k31_shmem")
    t, rep = run_cli(["find", "-graph", oracle + ".h5", "-ref", dep["ref"], "-out", mem,
                      "-scan-memory", "1", "-verbose", "0", "-profile"])
    times["find k=31 -scan-memory 1 (sharded-mem)"] = t
    log(f"find k=31 -scan-memory 1: {t:.2f} s; " + breakdown(rep))
    if not any(s.startswith("scan planes") for s in profile_lines(rep)):
        raise SmokeFailure("over-budget find did not take the sharded-mem plane path")
    _same_bytes(mem + ".breakpoints", oracle + ".breakpoints", "sharded-mem .breakpoints")
    _same_vcf(mem + ".othervariants.vcf", oracle + ".othervariants.vcf", "sharded-mem VCF")
    log("find k=31 sharded-mem: artifacts identical to the host oracle")
    times.update(fill_engines_agree(oracle + ".h5", oracle + ".breakpoints", work, 31,
                                    ["host", "device"], log=log))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on a mesh of 4 cards")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    # pin the card set before JAX initialises its backend
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", ",".join(str(i) for i in range(n_cards)))
    try:
        import jax

        import mindthegap_tpu  # noqa: F401  (enables x64)
    except ImportError as e:
        print(f"chip_smoke: the mindthegap_tpu package is not importable ({e})", file=sys.stderr)
        return 2
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPU(s); JAX found {len(devs)} x {devs[0].platform}",
              file=sys.stderr)
        return 2

    t_all = time.perf_counter()
    faulthandler.dump_traceback_later(1100, exit=True)  # stay inside 1200 s
    try:
        check_environment()
        with tempfile.TemporaryDirectory() as work:
            times = (four_cards if args.four_cards else one_card)(work, args.seed)
        smi = _nvidia_smi()
    finally:
        faulthandler.cancel_dump_traceback_later()
    for name, secs in times.items():
        print(f"time {name}: {secs:.2f} s")
    print(f"time total: {time.perf_counter() - t_all:.2f} s")
    print(f"card: {smi}")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
