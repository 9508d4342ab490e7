"""alga_tpu_torch — the overlap-graph assembler on PyTorch and CUDA.

A port of `alga_tpu` (JAX on a TPU) to NVIDIA Hopper GPUs: one card, or
a mesh of ranks on torch.distributed.  The JAX package stays the
reference: every module here keeps its counterpart's name, and the tests
hold each one against it on the CPU.

Layer map (same layers as alga_tpu, see its __init__):

  config.py         — AssemblyConfig and the reference's auto-tuning
  device.py         — device selection (CUDA unless "cpu" is asked for)
  native.py         — ctypes binding of the shared C++ host engine
                      (native/libalga_host.so at the repository root)
  core/             — 2-bit packing, SeqBatch
  io/fastx.py       — read ingest, preprocessing, prefix/duplicate marking
  io/multihost.py   — sharded ingest: each rank reads its own records
  corrector.py      — k-mer spectrum read correction
  store.py          — the numpy read store moved onto the device
  ops/              — window hashes, packed compares, ACLER, banded LCS
                      (the two hand-written CUDA kernels live in csrc/)
  graph/            — device GCPS overlap graph, LI/PKB supplement, and
                      the host passes: overlap_graph, simplify, contract
  contig/           — walk, host consensus, device consensus
  io/output.py      — contig filter, trim and FASTA output
  parallel/         — the mesh layer on torch.distributed (NCCL on CUDA,
                      gloo on the CPU): mesh and collectives, sharded GCPS,
                      prefix marking, simplification, chain discovery and
                      the distributed driver
  utils/            — timers and counters, serialize, libstdc++ sort and
                      glibc rand replicas, the edge oracle, Graphviz export
  pipeline.py, cli.py — end-to-end assembly

The host modules (config, native, core, io/fastx, corrector,
graph/{overlap_graph,simplify,contract}, contig/{walk,consensus}, utils
but oracle) are copies of alga_tpu's, kept in step with them.  Nothing here imports
jax or alga_tpu.
"""

__version__ = "0.1.0"
