"""CLI of the port, with the flags of alga_tpu/cli.py (ref
src/Params.cpp:237-506) plus `--device`.

Usage:
    python -m alga_tpu_torch.cli --file1 reads_1.fastq --file2 reads_2.fastq \\
        --output contigs.fasta [--error-rate 0.02] [--device cuda] \\
        [--profile_dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys

import torch

from alga_tpu_torch import device as device_mod
from alga_tpu_torch.pipeline import (AssemblyConfig, DataQualityError,
                                     assemble_to_file)

# the trace's span around the assembly (a user annotation)
TRACE_SPAN = "alga_tpu_torch.assemble"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="alga-tpu-torch",
        description="overlap-graph de-novo genome assembler (PyTorch/CUDA)",
    )
    p.add_argument("--file1", required=True, help="reads (FASTA/FASTQ), first mates")
    p.add_argument("--file2", default="", help="second mates (optional)")
    p.add_argument("--output", default="contigs.fasta")
    p.add_argument("--threads", type=int, default=6, help="host worker threads")
    p.add_argument("--error-rate", type=float, default=0.0, dest="error_rate",
                   help="expected sequencing error rate; >0.01 enables the "
                        "error-tolerant supplement")
    p.add_argument("--scale", type=float, default=0.55,
                   help="the single tuning knob (default 0.55)")
    p.add_argument("-l", "--min-overlap", type=int, default=-1,
                   dest="min_overlap",
                   help="minimum exact overlap (default: auto from read length)")
    p.add_argument("--retl", type=int, default=3, help="read end trim left")
    p.add_argument("--retr", type=int, default=3, help="read end trim right")
    p.add_argument("--remove_reads_with_n", type=int, default=1)
    p.add_argument("--rna", action="store_true")
    p.add_argument("--correct_reads", type=int, default=0, choices=[0, 1, 2],
                   help="k-mer spectrum read correction (2 = correct only)")
    p.add_argument("--no-native", action="store_true",
                   help="disable the C++ host engine (use Python twin)")
    p.add_argument("--serialize", type=int, default=0,
                   help="write graph checkpoints (reference-compatible binary)")
    p.add_argument("--deserialize_graph", type=int, default=0,
                   help="resume from graph checkpoints when present")
    p.add_argument("--redirect_cerr", type=int, default=0,
                   help="redirect stderr logs to <output>.log "
                        "(ref Params.cpp:578-594)")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of the assembly to this "
                        "directory")
    p.add_argument("--device", default=None,
                   help="torch device of the device phases (default: cuda; "
                        "'cpu' runs the plain PyTorch versions)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.redirect_cerr:
        sys.stderr = open(args.output.rsplit(".", 1)[0] + ".log", "w")
    cfg = AssemblyConfig(
        file1=args.file1,
        file2=args.file2,
        output=args.output,
        threads=args.threads,
        error_rate=args.error_rate,
        scale=args.scale,
        min_overlap_pref_suf=args.min_overlap,
        read_end_trim_left=args.retl,
        read_end_trim_right=args.retr,
        remove_reads_with_n=bool(args.remove_reads_with_n),
        rna=args.rna,
        correct_reads=args.correct_reads,
        use_native=not args.no_native,
        serialize_graph=bool(args.serialize),
        deserialize_graph=bool(args.deserialize_graph),
    )
    try:
        if args.profile_dir:
            profiled_assembly(cfg, args.device, args.profile_dir)
        else:
            assemble_to_file(cfg, device=args.device)
    except DataQualityError as e:
        # ref main.cpp:429-435: stderr message + exit(1)
        print(str(e), file=sys.stderr)
        return 1
    return 0


def profiled_assembly(cfg, device, profile_dir: str) -> str:
    """assemble_to_file under torch.profiler (CPU activity, and CUDA on a
    CUDA device), inside the span TRACE_SPAN; returns the path of the
    Chrome trace written into `profile_dir`.  On a CUDA device a trace
    without kernel events (no CUPTI) raises instead of being written."""
    from torch.profiler import ProfilerActivity, profile, record_function
    dev = device_mod.resolve(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(TRACE_SPAN):
            assemble_to_file(cfg, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{socket.gethostname()}_"
                                     f"{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    if dev.type == "cuda":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        if not any(e.get("cat") == "kernel" for e in events):
            os.remove(path)
            raise RuntimeError("torch.profiler recorded no CUDA kernel "
                               "(is CUPTI available?); no trace written")
    print(f"profile trace written to {path}", file=sys.stderr)
    return path


if __name__ == "__main__":
    raise SystemExit(main())
