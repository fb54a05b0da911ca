"""Where the Eq. 1 latency kernel's time goes: time a source of
``csrc/mccm_latency.cu`` against copies of it that each leave out one
part, at the shape ``chip_smoke.py``'s phase 6 times first (ResNet-50 on
ZCU102, 100,000 ``sample_mixed`` designs from seed 0 at 160 padded layers,
their ⟨pf, ph, pw⟩ as the batch path chooses them), in the order
A B C ... C B A on one card.

    python3 tools/latency_parts.py [--source PATH] [--against PATH]
                                   [--reps N]

``--source`` times another design of the kernel with the same C entry
(``mccm_latency``), such as an earlier commit's source; the default is the
checkout's.  ``--against PATH`` times the source against that other
design instead of its parts, at each of phase 6's three shapes (100,000
designs at 160 padded layers, the first 2,048 of them, all 100,000 at the
53 valid layers), in the order B A A B.  The copies, written under
``build/latency_parts/``, compute wrong answers and are only timed; each
changes the source in one place, and a part the source has no text for
is left out and reported:

- ``no_sum``: each design's total is its first layer's cycles (the loop
  that adds the other layers is gone);
- ``no_div``: the three divisions become products (``__fdiv_rn`` →
  ``__fmul_rn``);
- ``no_store``: the cycles are not written to global memory (the
  consumers' 16-byte stores; the element loop's store in a design that
  reads par straight from global memory);
- ``no_copy``: par is not copied after each block's first tile (the
  stream's bulk copies; in a design that reads par straight from global
  memory, its loads become loads of the staged dims, every tile).

The time a part takes is the source's time less its copy's.  Prints the
card's name and power limit, each build's ptxas registers and spills,
whether the source (and the other design) equals the plain version bit
for bit at each shape, one JSON line a timing (device ms a launch by CUDA
events, the mean of ``--reps`` launches), and a last JSON line with each
build's mean at each shape and the share of the source's mean it saves.
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: each copy: the texts of the source it may change, each with what it
#: becomes and how often it occurs; the first text found that often is used
VARIANTS = {
    "no_sum": [("for (int l = 1; l < L; ++l) acc = __fadd_rn(acc, row[l]);",
                "", 1)],
    "no_div": [("__fdiv_rn(", "__fmul_rn(", 3),
               ("return __fdiv_rn(a, b);", "return __fmul_rn(a, b);", 1)],
    "no_store": [("for (int i = lane; i < 8 * STEPS; i += 32) {",
                  "for (int i = lane; i < 0; i += 32) {", 1),
                 ("cyc[base + e] = c;", "", 1)],
    "no_copy": [("if (mid > 0) {",
                 "if (mid > 0 && ld.tile == static_cast<int>(blockIdx.x)) {",
                 1),
                ("const float pf = p[3 * e], ph = p[3 * e + 1], "
                 "pw = p[3 * e + 2];",
                 "const float pf = s_dims[0], ph = s_dims[1], "
                 "pw = s_dims[2];", 1)],
}


def variant_sources(source: Path, out_dir: Path) -> dict[str, Path]:
    """Write each copy of ``source`` that has a text to change; return the
    paths by name."""
    text = source.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in VARIANTS.items():
        for old, new, count in edits:
            if text.count(old) == count:
                path = out_dir / f"{source.stem}_{name}.cu"
                path.write_text(text.replace(old, new))
                paths[name] = path
                break
        else:
            print(json.dumps(dict(variant=name, skipped=f"no text of it "
                                  f"in {source.name}")), flush=True)
    return paths


def _shapes(smoke, device):
    """Phase 6's three shapes: (label, dims, par), par as the batch path
    chooses it for 100,000 ``sample_mixed`` ResNet-50 designs of seed 0."""
    _, _, t, dt, search, dims, db = smoke.latency_setup(device, 0, 100_000)
    par, _ = smoke._layer_par(db, t, dt, search)
    return (("main", dims, par), ("chunk", dims, par[:2048]),
            ("valid", dims[:t.L].contiguous(), par[:, :t.L].contiguous()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=None)
    ap.add_argument("--against", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("latency_parts: no CUDA card is visible", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from repro_torch.kernels._nvcc import load
    from repro_torch.kernels.mccm_eval import mccm_latency_ref, ops

    print(smoke.nvidia_smi(), flush=True)
    source = (args.source or ops.LATENCY_SOURCE).resolve()
    if args.against is None:
        paths = variant_sources(source, ROOT / "build" / "latency_parts")
    else:
        paths = {"against": args.against.resolve()}
    paths["source"] = source
    _, symbol, argtypes = ops._KERNELS["mccm_latency"]
    with ThreadPoolExecutor(len(paths)) as ex:
        futs = {n: ex.submit(load, p) for n, p in paths.items()}
        built = {n: f.result() for n, f in futs.items()}
    fns = {}
    for name, b in built.items():
        fn = getattr(b.lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
        print(json.dumps(dict(variant=name, build_s=b.seconds,
                              ptxas=smoke.ptxas_entries(b))), flush=True)

    device = torch.device("cuda:0")
    stream = torch.cuda.current_stream(device).cuda_stream
    shapes = _shapes(smoke, device)
    if args.against is None:
        shapes = shapes[:1]
        names = [n for n in VARIANTS if n in fns]
        order = ("source", *names, *reversed(names), "source")
    else:
        order = ("against", "source", "source", "against")
    out = {}
    for label, dims, par in shapes:
        B, L = par.shape[0], dims.shape[0]
        tot = torch.empty(B, device=device)
        cyc = torch.empty(B, L, device=device)
        ptrs = (dims.data_ptr(), par.data_ptr(), tot.data_ptr(),
                cyc.data_ptr(), B, L, stream)

        def launch(name):
            err = fns[name](*ptrs)
            if err != 0:
                raise RuntimeError(f"{name}: mccm_latency returned {err}")

        ref_tot, ref_cyc = mccm_latency_ref(dims, par)
        equal = {}
        for name in dict.fromkeys(order):
            if name in ("source", "against"):
                launch(name)
                equal[name] = (torch.equal(tot, ref_tot)
                               and torch.equal(cyc, ref_cyc))
        bound_ms = smoke._latency_bound(B, L)[0]
        print(json.dumps(dict(shape=label, designs=B, layers=L,
                              bound_ms=bound_ms, equal_plain=equal)),
              flush=True)
        readings: dict[str, list[float]] = {n: [] for n in order}
        for name in order:
            ms = smoke.cuda_ms(lambda: launch(name), args.reps)
            readings[name].append(ms)
            print(json.dumps(dict(shape=label, variant=name, ms=ms)),
                  flush=True)
        base = statistics.mean(readings["source"])
        out[label] = dict(bound_ms=bound_ms, means={
            n: dict(ms=statistics.mean(r), readings=r,
                    share=1 - statistics.mean(r) / base)
            for n, r in readings.items()})
    print(json.dumps({"reps": args.reps, "source": str(source),
                      "against": str(args.against), "shapes": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
