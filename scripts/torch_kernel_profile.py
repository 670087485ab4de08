#!/usr/bin/env python3
"""Static instruction mix and timed issue use of the port's pair kernels
(K1-K6) on an NVIDIA GPU, where ``ncu`` is not available.

    python3 scripts/torch_kernel_profile.py [--out FILE] [--root DIR]

(default ``build/kernel_profile.json``; ``--root`` profiles the
``nbody_tpu_torch`` package of another checkout, e.g. a parent commit
unpacked with ``git archive``, built into that checkout's ``build/``).

It builds the kernels (``nbody_tpu_torch/ops/_build.py``), reads their SASS
with ``cuobjdump -sass`` and, for every loop whose body holds a MUFU.RSQ
(one rsqrt a pair evaluation; MUFU.RSQ64H for a double rsqrt), counts the
body's instructions by pipe, leaving out the loops nested in it: the body's
instruction count over its rsqrt count is the issue cost of one pair
evaluation.  FP64 arithmetic and the F2F conversions have a pipe of their
own.  Then it times each kernel's wrapper with CUDA events at the main
path's shapes (random inputs; K6 on the Morton-sorted 65536 disc; K4 on a
[128, 2048] quadrupole slab whose massive rows are a prefix of 150-250 rows
a group, as the 1M walk's accepted nodes are; K2 full at 65536 and 2048,
and as the 4096-row oracle of a 2^20 state and the 1024-row one of the
65536 state) and derives

    issue use = pair evaluations * instructions a pair / 32
                / (time * SM clock * 4 schedulers * SMs),

the share of the card's warp-instruction issue slots the hot loop would
fill at that time (static counts: predicated-off and skipped work are not
seen).  Theoretical occupancy comes from the ``-Xptxas -v`` registers and
shared memory in ``build.log``.  It also reports the K2 oracle's own error
at 4096 x 2^20 against the plain sum in float64.  Prints one JSON object
and writes it to ``--out``.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PIPES = {
    "fp64": ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX", "F2F", "MUFU.RSQ64H"),
    "fp32": ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK"),
    "mufu": ("MUFU",),
    "lsu": ("LDS", "STS", "LDG", "STG", "LD", "ST", "LDSM", "LDGSTS",
            "LDGDEPBAR", "DEPBAR", "LDC", "ULDC"),
    "shfl": ("SHFL",),
    "int": ("IADD3", "IMAD", "ISETP", "LOP3", "SEL", "SHF", "LEA", "IABS",
            "IMNMX", "VIMNMX", "PRMT", "MOV", "IADD", "UIADD3", "UMOV",
            "ULOP3", "USHF", "UISETP", "ULEA", "UIMAD", "P2R", "R2P", "PLOP3",
            "S2R", "S2UR", "CS2R", "I2F", "F2I", "VOTE", "VOTEU", "POPC",
            "FLO"),
    "ctrl": ("BRA", "BAR", "BSYNC", "BSSY", "EXIT", "WARPSYNC", "CALL",
             "RET", "YIELD", "NOP", "BMOV"),
}


def pipe_of(op: str) -> str:
    base = op.split(".")[0]
    for pipe, ops in PIPES.items():
        if base in ops or any(op.startswith(o + ".") or op == o
                              for o in ops if "." in o):
            return pipe
    return "other"


INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"\s*([^;]*);")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
TARGET = re.compile(r"`\((\.L_x_\d+)\)|(0x[0-9a-f]+)")


def parse_sass(text):
    """{function name: [(address, opcode, operands)]}, labels resolved to
    the address of the next instruction."""
    funcs, cur, pending = {}, None, []
    for line in text.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            funcs[cur] = {"insns": [], "labels": {}}
            continue
        if cur is None:
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                funcs[cur]["labels"][lab] = addr
            pending = []
            funcs[cur]["insns"].append((addr, m.group(3), m.group(4)))
    return funcs


def hot_loops(func):
    """Every backward branch's body that holds a MUFU.RSQ outside the loops
    nested in it: {start, end, insns, rsqrt, per_pair, pipes (per pair)},
    each count over the body less its nested loops."""
    insns, labels = func["insns"], func["labels"]
    spans = []
    for addr, op, args in insns:
        if not op.startswith("BRA"):
            continue
        t = TARGET.search(args)
        if t is None:
            continue
        dest = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
        if dest is not None and dest < addr:
            spans.append((dest, addr))
    loops = []
    for a, b in set(spans):
        nested = [(c, d) for c, d in spans if a <= c and d <= b
                  and (c, d) != (a, b)]
        body = [o for x, o, _ in insns if a <= x <= b
                and not o.startswith("NOP")
                and not any(c <= x <= d for c, d in nested)]
        rsq = sum(o.startswith("MUFU.RSQ") for o in body)
        if not rsq:
            continue
        pipes = Counter(pipe_of(o) for o in body)
        loops.append({
            "start": hex(a), "end": hex(b), "insns": len(body),
            "rsqrt": rsq, "per_pair": round(len(body) / rsq, 3),
            "pipes_per_pair": {k: round(v / rsq, 3)
                               for k, v in sorted(pipes.items())},
            "opcodes": dict(Counter(body).most_common()),
        })
    # the pair loop: the most rsqrts a pass, and of loops with as many the
    # innermost (a compiler may peel a pass of it into the loop around it)
    inside = lambda l, o: (int(o["start"], 16) <= int(l["start"], 16)
                           and int(l["end"], 16) <= int(o["end"], 16)
                           and l is not o)
    for l in loops:
        l["innermost"] = not any(inside(o, l) for o in loops)
    loops.sort(key=lambda l: (-l["rsqrt"], not l["innermost"]))
    return loops


def demangle(names):
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not os.path.exists(tool):
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {
        n: n for n in names}


def normalised(name):
    """A demangled kernel name with its template arguments bare:
    kernel<(int)8, (bool)1> and kernel<8, true> both read kernel<8, 1>."""
    name = re.sub(r"\((int|bool)\)", "", name)
    return name.replace("true", "1").replace("false", "0")


def ptxas_report(log_text):
    """{mangled name: {registers, smem}} from nvcc's -Xptxas -v lines."""
    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            smem = re.search(r"(\d+) bytes smem", line)
            out[cur] = {"registers": int(m.group(1)),
                        "smem": int(smem.group(1)) if smem else 0}
    return out


def occupancy(regs, smem, threads):
    """Resident blocks and warps an SM (sm_90: 64K registers allocated per
    warp in 256-register units, 64 warps, 32 blocks, 228 KB shared)."""
    per_warp = -(-regs * 32 // 256) * 256
    warps = -(-threads // 32)
    blocks = min(32, 65536 // (per_warp * warps), 64 // warps,
                 (233472 // (smem + 1024)) if smem else 32)
    return {"blocks_per_sm": blocks, "warps_per_sm": blocks * warps,
            "theoretical_occupancy": blocks * warps / 64}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "kernel_profile.json"))
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose nbody_tpu_torch is profiled")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from nbody_tpu_torch.core.state import ParticleState, SimParams
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import group_force as gf
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.scenes import self_gravitating_disc

    cdll = _build.load_library()
    lib = _build.library_path()
    nvcc_dir = os.path.dirname(_build._nvcc())
    cuobjdump = os.path.join(nvcc_dir, "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs = parse_sass(sass)
    names = demangle(list(funcs))
    log = _build.BUILD_DIR / "build.log"
    ptx = ptxas_report(log.read_text()) if log.exists() else {}

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rows(*shape):
        t = torch.zeros(*shape, 8)
        t[..., :3] = torch.randn(*shape, 3, generator=gen)
        t[..., 3] = torch.rand(*shape, generator=gen) + 0.5
        return t.to(dev)

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def by_kernel(fn, reps):
        """Device time a call of each kernel the call launches (ms), from
        torch.profiler over ``reps`` calls."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if us and "kernel" in ev.key:
                out[normalised(ev.key)[:60]] = us / 1e3 / reps
        return out

    eps = 0.02
    n1 = 65536
    pos = torch.randn(n1, 3, generator=gen).to(dev)
    m1 = (torch.rand(n1, generator=gen) + 0.5).to(dev)
    t1m, s1m = rows(128, 8192), rows(128, 10240)
    t100, s100 = rows(25, 4096), rows(25, 8192)
    mask = (torch.rand(25, 8, 4, generator=gen) < 0.25).to(dev)
    t5 = rows(128, 8192)
    m5 = t5[..., 3].contiguous()
    unmasked = 1.0 - float(mask.float().mean())
    # K6: the CLI's disc, in the order brute-pallas-mxu gives the kernel
    p_, v_, m_ = self_gravitating_disc(65535, seed=0)
    st = ParticleState.create(p_, v_, m_, capacity=n1, device=dev)
    me = st.effective_mass()
    order = pw.mxu_order(st.pos, me, SimParams.create(device=dev).bounds)
    p6, m6 = st.pos[order].contiguous(), me[order].contiguous()
    # K2 as the sampled oracle of a 2^20 bh state: 4096 of its rows
    # (the disc + star as the CLI builds it, 4096 sorted alive rows drawn
    # as chip_smoke.py's bh checks draw them)
    p_, v_, m_ = self_gravitating_disc(1048575, seed=0)
    st20 = ParticleState.create(p_, v_, m_, device=dev)
    p20, m20 = st20.pos, st20.effective_mass()
    n20 = p20.shape[0]
    alive20 = np.nonzero(st20.alive.cpu().numpy())[0]
    t20 = p20[torch.as_tensor(np.sort(np.random.default_rng(0).choice(
        alive20, 4096, replace=False)), device=dev)].contiguous()
    # K2 as brute-pallas below 4096, and as the 65536 run's 1024-row oracle
    p2k, m2k = pos[:2048].contiguous(), m1[:2048].contiguous()
    t1k = pos[:1024].contiguous()

    def quad_rows(G, A, lo, hi):
        """[G, A, 16] quadrupole rows whose massive rows are a prefix of
        lo-hi rows a group; zero-mass rows carry Q = 0, as the walk's do."""
        q = torch.zeros(G, A, 16)
        q[..., :3] = torch.randn(G, A, 3, generator=gen) * 4.0
        q[..., 3] = torch.rand(G, A, generator=gen) + 0.5
        q[..., 4:10] = torch.randn(G, A, 6, generator=gen) * 1e-2
        live = torch.randint(lo, hi + 1, (G, 1, 1), generator=gen)
        return torch.where(torch.arange(A)[None, :, None] < live, q,
                           0.0).to(dev)

    # K4 at the 1M tier: 128 groups of 8192 targets against [128, 2048]
    # rows; at the 100k tier: the block-dual rows (4 source tiles a target
    # tile, each accepted with probability 1/2, in the first 4 of 128 rows)
    # and the accepted nodes
    t4, q4 = rows(128, 8192), quad_rows(128, 2048, 150, 250)
    td, qd = rows(200, 512), quad_rows(200, 128, 4, 4)
    qd *= (torch.rand(200, 128, 1, generator=gen) < 0.5).to(dev)
    ta, qa = rows(25, 4096), quad_rows(25, 2048, 250, 300)
    # the pairs K4 evaluates: the rows of each live 128-row stage up to its
    # last massive row, rounded up to the kernel's unroll width (a whole
    # stage before that width existed)
    unroll = (cdll.nbody_k4_unroll() if hasattr(cdll, "nbody_k4_unroll")
              else 128)

    def k4_pairs(tgt, q):
        m = (q[..., 3] != 0).reshape(q.shape[0], -1, 128).cpu()
        idx = torch.arange(128).expand_as(m)
        last = torch.where(m, idx, -1).amax(-1) + 1
        rows_ = torch.clamp(-(-last // unroll) * unroll, max=128)
        return tgt.shape[1] * int(rows_.sum())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # (label, kernel instance (normalised name), call, pair evaluations,
    # reps); the instance is the one the wrapper launches at eps > 0
    cases = [
        ("K1 N=65536 (tiles + reduction)", "acc_sym_tiles_kernel<3, 1>",
         lambda: pw.pairwise_acc_sym(pos, m1, 1.0, eps),
         n1 * (n1 + 1) / 2, 20),
        ("K3 unmasked [128,8192]x[128,10240]",
         "group_force_kernel<1, 0>",
         lambda: gf.group_force(t1m, s1m, 1.0, eps, tile=2048),
         128 * 8192 * 10240, 10),
        ("K3 masked [25,4096]x[25,8192], mask [25,8,4]",
         "group_force_kernel<1, 1>",
         lambda: gf.group_force(t100, s100, 1.0, eps, tile=2048, mask=mask),
         25 * 4096 * 8192 * unmasked, 20),
        ("K5 [128,8192] (tiles + reduction)", "acc_sym_tiles_kernel<8, 1>",
         lambda: gf.group_self_force(t5, m5, 1.0, eps),
         128 * 8192 * 8193 / 2, 10),
        ("K4 [128,8192]x[128,2048], 150-250 massive rows a group",
         "quad_force_kernel<1>",
         lambda: gf.quad_force(t4, q4, 1.0, eps, tile=512),
         k4_pairs(t4, q4), 20),
        ("K4 100k dual rows [200,512]x[200,128], <= 4 massive",
         "quad_force_kernel<1>",
         lambda: gf.quad_force(td, qd, 1.0, eps, tile=128),
         k4_pairs(td, qd), 50),
        ("K4 100k accepted [25,4096]x[25,2048], 250-300 massive",
         "quad_force_kernel<1>",
         lambda: gf.quad_force(ta, qa, 1.0, eps, tile=512),
         k4_pairs(ta, qa), 50),
        ("K6 N=65536 sorted disc, tiles 512x1024", "acc_mxu_kernel<1>",
         lambda: pw.pairwise_acc_mxu(p6, m6, 1.0, eps), n1 * n1, 10),
        ("K2 full N=65536 (pack + chunks + reduction)",
         "acc_targets_kernel<1>",
         lambda: pw.pairwise_acc(pos, m1, 1.0, eps), n1 * n1, 10),
        ("K2 oracle 4096 x 2^20 (pack + chunks + reduction)",
         "acc_targets_kernel<1>",
         lambda: pw.pairwise_acc_targets(t20, p20, m20, 1.0, eps),
         4096 * n20, 3),
        ("K2 full N=2048 (pack + chunks + reduction)",
         "acc_targets_kernel<1>",
         lambda: pw.pairwise_acc(p2k, m2k, 1.0, eps), 2048 * 2048, 200),
        ("K2 1024 x 65536 (pack + chunks + reduction)",
         "acc_targets_kernel<1>",
         lambda: pw.pairwise_acc_targets(t1k, pos, m1, 1.0, eps),
         1024 * n1, 50),
    ]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    timed = []
    for label, inst, fn, pairs, reps in cases:
        t = ms(fn, reps)
        clk = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits"], capture_output=True, text=True).stdout.strip()
        timed.append({"case": label, "kernel": inst, "ms": t,
                      "pair_evaluations": pairs,
                      "sm_clock_mhz_after": clk,
                      "device_ms_by_kernel": by_kernel(fn, reps)})

    # the oracle's own error: max-row |a - a64| over the mean row |a64|,
    # a64 the plain sum in float64
    got = pw.pairwise_acc_targets(t20, p20, m20, 1.0, eps).double()
    ref = pw.pairwise_acc_targets_plain(t20.double(), p20.double(),
                                        m20.double(), 1.0, eps, tile=128)
    k2_vs_f64 = ((got - ref).norm(dim=1).max()
                 / ref.norm(dim=1).mean()).item()
    row = ((got - ref).norm(dim=1) / ref.norm(dim=1)).cpu()
    k2_oracle_error = {"rel_err_vs_float64": k2_vs_f64,
                       "row_median_vs_float64": row.median().item(),
                       "row_max_vs_float64": row.max().item()}

    kernels = {}
    for mangled, func in funcs.items():
        name = names[mangled]
        if not any(k in name for k in ("acc_sym_tiles_kernel",
                                       "group_force_kernel",
                                       "acc_targets_kernel",
                                       "quad_force_kernel",
                                       "acc_mxu_kernel")):
            continue
        loops = hot_loops(func)
        info = {"sass_instructions": len(func["insns"]),
                "hot_loops": loops}
        if mangled in ptx:
            info.update(ptx[mangled])
            # K2's block: _K2_THREADS (a tree without it ran 128 threads)
            threads = (256 if "acc_sym_tiles" in name else
                       getattr(pw, "_K2_THREADS", 128)
                       if "acc_targets" in name else 128)
            info.update(occupancy(ptx[mangled]["registers"],
                                  ptx[mangled]["smem"], threads))
        kernels[name] = info

    max_clk = float(re.findall(r"(\d+) MHz", smi)[-1]) * 1e6 if "MHz" in smi \
        else 1.98e9
    for t in timed:
        # the hot loop of the matching kernel instance: the one that runs
        # the most rsqrts a pass, its nested loops left out (the pair loop;
        # a peeled or guarded variant nested in it is counted apart).  A
        # tree without the instance, e.g. an older one, matches by the
        # kernel's bare name.
        inst = t["kernel"]
        if not any(inst in normalised(n) for n in kernels):
            inst = inst.split("<")[0]
        hot = [l for n, k in kernels.items() if inst in normalised(n)
               for l in k["hot_loops"][:1]]
        if hot:
            ipp = max(l["per_pair"] for l in hot)
            t["pipes_per_pair"] = max(hot, key=lambda l: l["per_pair"])[
                "pipes_per_pair"]
            slots = t["ms"] * 1e-3 * max_clk * 4 * sms
            t["instructions_per_pair"] = ipp
            t["issue_use_at_max_clock"] = (t["pair_evaluations"] * ipp / 32
                                           / slots)
    result = {"device": smi.strip(), "sms": sms, "timed": timed,
              "k2_oracle_error": k2_oracle_error, "kernels": kernels}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    brief = {"device": result["device"], "timed": timed,
             "k2_oracle_error": k2_oracle_error, "kernels": {
        n: {k: v for k, v in i.items() if k != "hot_loops"}
        | {"hot_loops": [{k: v for k, v in l.items() if k != "opcodes"}
                         for l in i["hot_loops"]]}
        for n, i in kernels.items()}}
    print(json.dumps(brief, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
