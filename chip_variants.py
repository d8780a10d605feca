#!/usr/bin/env python3
"""Design probes of the scan kernels on one GPU: variants of this tree's
csrc/wkv6.cu and csrc/ssm_scan.cu, made by substituting lines of the
source, built with the same nvcc flags into build/variants/ and timed at the
serve shapes of chip_smoke.py, each beside the kernel as built and checked
against the plain version; plus the card's attainable float32 FMA rate.

    python3 chip_variants.py       # from the root of a checkout, one GPU

Variants (``ms`` the median device time, ``excess`` over 2 bf16 ulps +
1e-4 and ``state_err`` as in chip_smoke.py's scan checks):

* ``wkv6_rows_hd/16`` and ``wkv6_rows_hd/4``: the prefill kernel with 4 and
  16 rows a lane in place of 8 (so 8 and 2 warps a head in place of 4);
* ``ssm_expf``: the prefill kernel's exponential as the accurate expf of
  -exp(A_log) dt in place of one MUFU ex2 of its log2(e)-scaled form;
* ``*_no_barrier`` (timing only: its results are wrong) and
  ``ssm_no_y_store`` (timing only): what the chunk barrier and the per-step
  store of y cost;
* ``fma_rate``: a kernel of independent FFMA chains on every SM, its
  float32 rate against the 67 TFLOP/s of the data sheet.

Backward variants, at the hybrid updates' shape (32 rows of 127 steps,
bf16; chip_smoke.py's check_wkv6_bwd and check_ssm_scan_bwd), each timed
through this tree's wrappers with the variant's library in place: the
backward reading the boundary states its forward stored (``bwd_ms``), the
forward without and with those stores (``fwd_ms``, ``fwd_save_ms``), a
layer's share of an update under remat (``update_ms``: the forward with its
stores twice, the step's and the recompute's, then the backward), the
backward checked against the plain backward (``excess``, as chip_smoke.py's
bwd_excess) and against itself across two launches (``bit_equal``), and
ptxas's registers and spills of the backward kernel with its shared memory:

* ``wkv6_bwd_C1_KB{4,8,16}_KH4``: csrc/wkv6.cu's kernel (one block a head)
  with boundaries every KB steps (8 as built), KH steps of S_{t-1} kept in
  shared memory;
* ``wkv6_bwd_C{2,4}_KB{4,8,16}_KH{4,8,16}``: a head's columns over a
  cluster of C blocks, variants/wkv6_bwd_cluster.cu appended to
  csrc/wkv6.cu in place of its backward;
* ``ssm_bwd_{96,160,320}`` (160 as built, a launch bound of 4 blocks an
  SM; ``_3blk`` 3) threads a block, ``ssm_bwd_K4`` boundaries every 4 steps
  in place of 8.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
CLUSTER_SRC = ROOT / "variants" / "wkv6_bwd_cluster.cu"
OUT = ROOT / "build" / "variants"

# name: (source, [(a line as built, its substitute), ...])
VARIANTS = {
    "wkv6_as_built": ("wkv6.cu", []),
    "wkv6_rows_hd/16": ("wkv6.cu", [("using ScanTile = Tile<HD, HD / 8>;",
                                     "using ScanTile = Tile<HD, HD / 16>;")]),
    "wkv6_rows_hd/4": ("wkv6.cu", [("using ScanTile = Tile<HD, HD / 8>;",
                                    "using ScanTile = Tile<HD, HD / 4>;")]),
    "wkv6_no_barrier": ("wkv6.cu", [
        ("    __syncthreads();  // chunk c and its Qs, c + 1 landed",
         "    // chunk c and its Qs, c + 1 landed")]),
    "ssm_as_built": ("ssm_scan.cu", []),
    "ssm_expf": ("ssm_scan.cu", [
        ("h[k] = ex2(a2[k] * dv) * h[k] + dx * bn[k];",
         "h[k] = expf(a2[k] * dv) * h[k] + dx * bn[k];")]
        + [(f"a2[{i}] = -expf(a4.{c}) * repro::tc::kLog2e;",
            f"a2[{i}] = -expf(a4.{c});") for i, c in enumerate("xyzw")]),
    "ssm_no_barrier": ("ssm_scan.cu", [
        ("    __syncthreads();  // chunk ch widened, ch + 1",
         "    // chunk ch widened, ch + 1")]),
    "ssm_no_y_store": ("ssm_scan.cu", [
        ("if (live && q == 0) *yp =",
         "if (live && q == 0 && acc == 12345.f) *yp =")]),
}

WKV_K = "constexpr int kBwdChunk = 8;"
WKV_H = "constexpr int kBwdHist = 4;       // steps of S_{t-1} a block keeps"
WKV_ENTRY = ('// written 16 bytes at a time (16-byte aligned).\n'
             'extern "C" int wkv6_bwd(')     # csrc/wkv6.cu's entry
WKV_C = "constexpr int cluster_of() { return HD / 16; }"
WKV_MIN = "constexpr int kClusterMinBlocks = 2;  // blocks an SM"
SSM_NT = "constexpr int kBwdThreads = 160;  // (row, channel, 4 states) a thread"
SSM_MIN = "constexpr int kBwdMinBlocks = 4;  // blocks an SM"


def _wkv(C, KB, KH, blocks=2):
    """The WKV6 backward with boundaries every KB steps and KH steps of
    S_{t-1} kept; with C > 1 the cluster kernel in its place (C = 4: hd / 16
    blocks at every hd; C = 2: 2 at hd 32 and 64), ``blocks`` an SM."""
    subs = []
    if KB != 8:
        subs.append((WKV_K, WKV_K.replace("8;", f"{KB};")))
    if KH != 4:
        subs.append((WKV_H, WKV_H.replace("4;", f"{KH};")))
    if C == 1:
        return ("wkv6.cu", subs)
    subs.append((WKV_ENTRY, WKV_ENTRY.replace("wkv6_bwd(", "wkv6_bwd_single(")))
    if C == 2:
        subs.append((WKV_C, WKV_C.replace("HD / 16", "HD > 16 ? HD / 32 : 1")))
    if blocks != 2:
        subs.append((WKV_MIN, WKV_MIN.replace("2;", f"{blocks};")))
    return ("wkv6.cu", subs, CLUSTER_SRC)


BWD_VARIANTS = {
    "wkv6_bwd_C1_KB8_KH4": _wkv(1, 8, 4),
    "wkv6_bwd_C1_KB4_KH4": _wkv(1, 4, 4),
    "wkv6_bwd_C1_KB16_KH4": _wkv(1, 16, 4),
    "wkv6_bwd_C2_KB4_KH4": _wkv(2, 4, 4, blocks=4),
    "wkv6_bwd_C2_KB8_KH8": _wkv(2, 8, 8),
    "wkv6_bwd_C4_KB8_KH8": _wkv(4, 8, 8, blocks=3),
    "wkv6_bwd_C4_KB16_KH16": _wkv(4, 16, 16),
    "ssm_bwd_160": ("ssm_scan.cu", []),
    "ssm_bwd_160_3blk": ("ssm_scan.cu", [
        (SSM_MIN, SSM_MIN.replace("4;", "3;"))]),
    "ssm_bwd_320": ("ssm_scan.cu", [
        (SSM_NT, SSM_NT.replace("160", "320")),
        (SSM_MIN, SSM_MIN.replace("4;", "2;"))]),
    "ssm_bwd_96": ("ssm_scan.cu", [
        (SSM_NT, SSM_NT.replace("160", "96")),
        (SSM_MIN, SSM_MIN.replace("4;", "6;"))]),
    "ssm_bwd_K4": ("ssm_scan.cu", [
        ("constexpr int kBwdChunk = 8;", "constexpr int kBwdChunk = 4;"),
        (SSM_MIN, SSM_MIN.replace("4;", "6;"))]),
}

FMA_PROBE = r"""
#include <cuda_runtime.h>
// 8 independent FFMA chains a thread: its float32 rate, not its latency
__global__ void fma_probe_kernel(float* out, int iters) {
  float a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = threadIdx.x * 1e-3f + k;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = fmaf(a[k], 0.999f, 0.5f);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int fma_probe(float* out, int blocks, int threads, int iters,
                         void* stream) {
  fma_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def build_variants(build):
    """One shared library per variant (and the FMA probe), built in
    parallel: {name: path}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, subs, *append) in {**VARIANTS, **BWD_VARIANTS}.items():
        text = "".join(p.read_text() for p in [CSRC / src, *append])
        for line, sub in subs:
            if text.count(line) != 1:
                cs.fail(f"variant {name}: '{line}' is not one line of {src}")
            text = text.replace(line, sub)
        path = OUT / (name.replace("/", "_") + ".cu")
        path.write_text(text)
        procs[name] = path
    probe = OUT / "fma_probe.cu"
    probe.write_text(FMA_PROBE)
    procs["fma_rate"] = probe
    running = {name: (subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(CSRC), "-o",
         str(path.with_suffix(".so")), str(path)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), path)
        for name, path in procs.items()}
    libs = {}
    for name, (proc, path) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"variant {name} does not build:\n{log[-3000:]}")
        path.with_suffix(".log").write_text(log)
        libs[name] = path.with_suffix(".so")
    return libs


def ptxas_of(log, kernel):
    """[registers, spill stores, spill loads] of the bf16 instantiation of
    ``kernel`` (a mangled-name fragment) in an nvcc -Xptxas -v log."""
    import re
    for entry, body in re.findall(
            r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
            log, re.S):
        if kernel in entry and "nv_bfloat16" in entry:
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", body)
            return [int(regs.group(1)), int(spill.group(1)),
                    int(spill.group(2))]
    return None


def backward_variants(torch, build, timer, libs, rwkv6_scan, ssm_scan):
    """Each backward variant at the hybrid updates' shape through this
    tree's wrappers, its library in place of the built one."""
    import ctypes
    g = torch.Generator(device="cuda").manual_seed(65)
    B, T, H, hd = cs.TRAIN_B, cs.TRAIN_S, 32, 64
    r, k, v = (torch.randn(B, T, H, hd, device="cuda", generator=g)
               .mul(0.5).bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, T, H, hd, device="cuda",
                                         generator=g) * 0.5 - 1.0)).bfloat16()
    u = torch.randn(H, hd, device="cuda", generator=g) * 0.3
    s0 = torch.randn(B, H, hd, hd, device="cuda", generator=g) * 0.2
    dy = torch.randn(B, T, H, hd, device="cuda", generator=g).bfloat16()
    wkv = (r, k, v, w, u)
    wkv_want = rwkv6_scan.wkv6_bwd_plain(*wkv, s0, dy)
    di, N = 3200, 16
    ssm = cs.ssm_inputs(torch, B, T, di, N, torch.bfloat16, g, model_A=True)
    sdy = torch.randn(B, T, di, device="cuda", generator=g).bfloat16()
    ssm_want = ssm_scan.selective_scan_bwd_plain(*ssm, sdy)
    for name, (src, *_) in BWD_VARIANTS.items():
        lib = ctypes.CDLL(str(libs[name]))
        wk = src == "wkv6.cu"
        lib_name = "wkv6" if wk else "ssm_scan"
        for fn, argtypes in build.KERNELS[lib_name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        mod = rwkv6_scan if wk else ssm_scan
        inputs, state, grad = (wkv, s0, dy) if wk else (ssm[:6], ssm[6], sdy)
        want = wkv_want if wk else ssm_want

        def run():
            ckpt = (mod.boundaries(inputs[0]) if wk
                    else mod.boundaries(inputs[0], N))
            work = state.clone()
            mod.launch(*inputs, work, ckpt=ckpt)
            got = mod.launch_bwd(*inputs, state, grad, ckpt=ckpt)
            again = mod.launch_bwd(*inputs, state, grad, ckpt=ckpt)
            torch.cuda.synchronize()
            ex = cs.bwd_excess(torch, got, want)[0]
            same = all(torch.equal(a, b) for a, b in zip(got, again))

            def update():
                # a layer's share of an update under remat: the forward
                # with its stores twice (the step's and the recompute's),
                # the backward once
                for _ in range(2):
                    mod.launch(*inputs, work, ckpt=ckpt)
                mod.launch_bwd(*inputs, state, grad, ckpt=ckpt)

            times = dict(
                bwd_ms=timer(lambda: mod.launch_bwd(*inputs, state, grad,
                                                    ckpt=ckpt)),
                fwd_ms=timer(lambda: mod.launch(*inputs, work)),
                fwd_save_ms=timer(lambda: mod.launch(*inputs, work,
                                                     ckpt=ckpt)),
                update_ms=timer(update))
            return ex, same, times

        ex, same, times = cs.with_libraries(build, {lib_name: lib}, run)
        n = ctypes.c_int()
        extra = {}
        if wk:
            chunk = lib.wkv6_bwd_chunk(hd, 1, ctypes.addressof(n))
            if hasattr(lib, "wkv6_bwd_info"):     # the cluster kernel's
                info = (ctypes.c_int * 3)()
                lib.wkv6_bwd_info.argtypes = [build.I, build.I, build.P]
                build.check(lib.wkv6_bwd_info(hd, 1, ctypes.addressof(info)),
                            "wkv6_bwd_info")
                n.value = info[0]
                extra = dict(cluster=info[1], clusters_resident=info[2])
        else:
            chunk = lib.ssm_scan_bwd_chunk(N, 1, ctypes.addressof(n))
            extra = dict(channels_a_block=lib.ssm_scan_bwd_channels(N))
        log = libs[name].with_suffix(".log").read_text()
        kernel = ("wkv6_bwd_cluster_kernel" if "cluster" in extra
                  else "wkv6_bwd_kernel" if wk else "ssm_scan_bwd_kernel")
        cs.emit("bwd_variant", name=name, shape=f"[{B}, {T}, " + (
            f"{H}, {hd}]" if wk else f"{di}], N {N}"), bf16=True,
            chunk=chunk, smem_bytes=n.value, ptxas=ptxas_of(log, kernel),
            excess_over_tol=ex, bit_equal=same, **times, **extra)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        cs.fail("CUDA is not available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.hopper import build, rwkv6_scan, ssm_scan
    P, I = build.P, build.I
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0))
    libs = build_variants(build)
    timer = cs.Timer(torch)
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(43)

    B, T, H, hd = 16, cs.PREFILL_T, 32, 64
    r, k, v = (torch.randn(B, T, H, hd, device="cuda", generator=g)
               .mul(0.5).bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, T, H, hd, device="cuda",
                                         generator=g) * 0.5 - 1.0)).bfloat16()
    u = torch.randn(H, hd, device="cuda", generator=g) * 0.3
    s0 = torch.randn(B, H, hd, hd, device="cuda", generator=g) * 0.2
    wkv_want = rwkv6_scan.wkv6_plain(r, k, v, w, u, s0)
    di, N = 3200, 16
    ssm_args = cs.ssm_inputs(torch, B, T, di, N, torch.bfloat16, g,
                             model_A=True)
    ssm_want = ssm_scan.selective_scan_plain(*ssm_args)

    def wkv_call(lib, state):
        y = torch.empty_like(r)
        build.check(lib.wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), B, T, H, hd, 1, 0,
            stream), "wkv6_fwd")
        return y

    def ssm_call(lib, state):
        x, dt, A_log, Bc, Cc, D, _ = ssm_args
        y = torch.empty_like(x)
        build.check(lib.ssm_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), D.data_ptr(), state.data_ptr(), y.data_ptr(), B,
            T, di, N, Bc.stride(0), Bc.stride(1), Cc.stride(0), Cc.stride(1),
            1, 0, stream), "ssm_scan_fwd")
        return y

    for name, path in libs.items():
        if name not in VARIANTS:
            continue
        lib = ctypes.CDLL(str(path))
        wkv = VARIANTS[name][0] == "wkv6.cu"
        fn = lib.wkv6_fwd if wkv else lib.ssm_scan_fwd
        fn.argtypes = ([P] * 7 + [I] * 6 + [P] if wkv
                       else [P] * 8 + [I] * 10 + [P])
        fn.restype = ctypes.c_int
        call = wkv_call if wkv else ssm_call
        s_init = s0 if wkv else ssm_args[6]
        want_y, want_s = wkv_want if wkv else ssm_want
        state = s_init.clone()
        y = call(lib, state)
        torch.cuda.synchronize()
        excess = cs.bf16_excess(torch, y, want_y)
        s_err = float((state - want_s).abs().max() / want_s.abs().max())
        work = s_init.clone()
        cs.emit("variant", name=name, shape=f"[{B}, {T}, " + (
            f"{H}, {hd}]" if wkv else f"{di}], N {N}"), bf16=True,
            ms=timer(lambda: call(lib, work)), excess_over_tol=excess,
            state_err_of_max=s_err)

    backward_variants(torch, build, timer, libs, rwkv6_scan, ssm_scan)

    lib = ctypes.CDLL(str(libs["fma_rate"]))
    lib.fma_probe.argtypes = [P, I, I, I, P]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = sms * 8, 256, 16384
    out = torch.empty(blocks * threads, device="cuda")
    ms = timer(lambda: build.check(lib.fma_probe(
        out.data_ptr(), blocks, threads, iters, stream), "fma_probe"))
    flops = 2.0 * 8 * iters * blocks * threads
    cs.emit("fma_rate", blocks=blocks, threads=threads, chains_a_thread=8,
            iters=iters, ms=ms, tflops=flops / ms / 1e9,
            of_peak=flops / ms / 1e9 / (cs.PEAK_F32_FLOPS / 1e12))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
