"""The distributed assembly driver (port of alga_tpu/parallel/distributed.py;
the reference's one process, ref src/main.cpp:57-779, split over ranks).

Every rank of a mesh calls `assemble_distributed(cfg, mesh)`:

  1. it ingests only its own records (io/multihost); the packed store
     stays in per-rank blocks on the devices until the contig phase;
  2. duplicate and prefix reads are marked over the mesh
     (parallel/sharded_preprocess);
  3. the dense-id remap is computed on the host from the small per-slot
     arrays alone (lengths, valid, paired offsets);
  4. GCPS runs over the mesh directly on slot ids, with the validity
     masks excluding dropped rows; every tie-break of GCPS is order-based,
     so renumbering the edges to dense ids afterwards gives the graph of
     the compacted store;
  5. simplification and the contraction's chain discovery run over the
     mesh on the dense graph;
  6. the kept rows of the store are gathered to rank 0 in chunks, and
     rank 0 alone walks, builds consensus, filters, trims and writes;
     the other ranks return a result with no contigs.

Rank 0's FASTA equals the single-process `pipeline.assemble` output on
the same files.  The corrector and the LI/PKB supplement (error_rate >
0.01) work on the whole store, so those configurations take the gathered
route: every rank gathers the store and runs `pipeline.assemble` on the
mesh.  Inputs the mesh route cannot take raise named errors rather than
write other output: an interleaved .pfasta file
(multihost.UnsupportedInputError), reads under 16 bases
(sharded_preprocess.ShortReadError), and no valid read left after
simplification (pipeline.DataQualityError).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from alga_tpu_torch import config, pipeline
from alga_tpu_torch.config import AssemblyConfig
from alga_tpu_torch.contig import consensus, walk
from alga_tpu_torch.core.seqbatch import SeqBatch
from alga_tpu_torch.graph import contract
from alga_tpu_torch.graph.overlap_graph import OverlapGraph
from alga_tpu_torch.io import output
from alga_tpu_torch.io.multihost import load_read_batch_distributed
from alga_tpu_torch.parallel import mesh as mesh_mod
from alga_tpu_torch.parallel.sharded_contract import chain_terminals_sharded
from alga_tpu_torch.parallel.sharded_gcps import gcps_graph_sharded
from alga_tpu_torch.parallel.sharded_preprocess import mark_prefix_sharded
from alga_tpu_torch.parallel.sharded_simplify import \
    simplify_graph_old_sharded
from alga_tpu_torch.utils import timers as timers_mod
from alga_tpu_torch.utils.timers import PhaseTimer


def _log(*a):
    print(*a, file=sys.stderr)


def _host(mesh, x: torch.Tensor) -> np.ndarray:
    """Every rank's block of a per-row tensor, gathered, as numpy."""
    return mesh_mod.gather_all(mesh, x, "dist_gather").cpu().numpy()


def gathered_batch(mesh, file1: str, file2: str | None = None,
                   **pre_kw) -> SeqBatch:
    """The distributed ingest gathered on every rank: a SeqBatch equal to
    fastx.load_read_batch(file1, file2), padding rows stripped."""
    pk, ln, vd, nrows = load_read_batch_distributed(mesh, file1, file2,
                                                    **pre_kw)
    return SeqBatch(_host(mesh, pk).view(np.uint32)[:nrows].copy(),
                    _host(mesh, ln)[:nrows].copy(),
                    _host(mesh, vd)[:nrows].copy())


class _ValidShim:
    """The batch surface the sharded simplifier touches."""

    def __init__(self, valid: np.ndarray, lengths: np.ndarray):
        self.valid = valid
        self.lengths = lengths

    def avg_read_length(self) -> float:
        if not self.valid.any():
            return 0.0
        return float(self.lengths[self.valid].mean())


def _gather_packed_to_proc0(mesh, packed_l: torch.Tensor, keep: np.ndarray,
                            chunk_rows: int = 1 << 18) -> np.ndarray | None:
    """The kept rows of the store, in slot order, on rank 0 (None on the
    others), gathered in chunks of `chunk_rows` rows per rank: a rank other
    than 0 never holds more than its block and one chunk."""
    per, w = packed_l.shape
    is0 = mesh.rank == 0
    newid = np.cumsum(keep) - 1          # dense id of each kept slot
    out = np.empty((int(keep.sum()), w), dtype=np.uint32) if is0 else None
    timers_mod.bump("dist_store_host_rows",
                    (len(out) if is0 else 0) + chunk_rows * mesh.d)
    for c0 in range(0, per, chunk_rows):
        part = packed_l[c0:c0 + chunk_rows].contiguous()
        parts = ([torch.empty_like(part) for _ in range(mesh.d)] if is0
                 else None)
        dist.gather(part, parts, dst=0, group=mesh.group)
        nbytes = part.numel() * part.element_size()
        mesh_mod.count_bytes("store_to_rank0", nbytes, 0 if is0 else nbytes)
        if not is0:
            continue
        for p, rows in enumerate(parts):
            glo = p * per + c0
            m = keep[glo:glo + rows.shape[0]]
            if m.any():
                first = int(newid[glo + int(np.argmax(m))])
                got = rows.cpu().numpy().view(np.uint32)[m]
                out[first:first + len(got)] = got
    return out


def assemble_distributed(cfg: AssemblyConfig, mesh=None,
                         write_output: bool = True):
    """Sharded ingest, preprocessing and graph phases, then the contigs
    on rank 0.  Call from every rank of the mesh (`make_mesh()` when
    None: CUDA, one card per rank).  Rank 0 returns the full
    AssemblyResult and writes `cfg.output` when `write_output`; the other
    ranks return a result with no contigs."""
    if mesh is None:
        mesh = mesh_mod.make_mesh()
    pre_kw = dict(trim_left=cfg.read_end_trim_left,
                  trim_right=cfg.read_end_trim_right, rna=cfg.rna,
                  str_period=cfg.str_period_threshold)
    if cfg.correct_reads or cfg.error_rate > 0.01:
        _log("[distributed] corrector/supplement configuration: the "
             "gathered route")
        batch = gathered_batch(mesh, cfg.file1, cfg.file2 or None, **pre_kw)
        res = pipeline.assemble(cfg, batch=batch, paired=bool(cfg.file2),
                                mesh=mesh)
        if write_output and mesh.rank == 0:
            output.write_contigs(res.contigs, cfg.output, rna=cfg.rna)
        return res

    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    timers_mod.reset_counters()
    timers = PhaseTimer()
    timers.start("total")
    paired = bool(cfg.file2)

    # --- 1: sharded ingest (the store stays in per-rank blocks) ------------
    with timers.phase("input_reader"):
        packed_l, lengths_l, valid_l, nrows = load_read_batch_distributed(
            mesh, cfg.file1, cfg.file2 or None, **pre_kw)
        lengths = _host(mesh, lengths_l).astype(np.int64)
        valid = _host(mesh, valid_l)
        npad = len(lengths)
    _log(f"[distributed] {int(valid.sum())} valid reads of {nrows} slots "
         f"({npad} padded rows over {mesh.d} ranks)")
    avg = float(lengths[valid].mean()) if valid.any() else 0.0
    tcfg = config.autotune(cfg, avg)

    # --- 2: duplicate and prefix marking over the mesh ----------------------
    with timers.phase("read_preprocess"):
        marked = mark_prefix_sharded(mesh, packed_l, lengths, valid)
        valid &= ~marked
    _log(f"[distributed] {int(marked.sum())} prefix/duplicate reads removed")

    # --- 3: the dense remap, on the per-slot arrays alone -------------------
    # (pipeline.remap_paired_offsets applied to flags: no packed row moves)
    with timers.phase("remap"):
        valid_pair = valid[0::2] & valid[1::2]
        keep = np.repeat(valid_pair, 2)
        po = np.zeros(npad, dtype=np.int8)
        if paired and npad:
            both = valid_pair[0::2] & valid_pair[1::2]
            po.reshape(-1, 4)[both] = np.array([1, 1, 2, 2], dtype=np.int8)
        newid = np.cumsum(keep) - 1
        n_dense = int(keep.sum())
        lengths_dense = lengths[keep]
        po_dense = po[keep]
    _log(f"[distributed] {n_dense} reads after remap")

    # --- 4: GCPS over the mesh, on slot ids ---------------------------------
    with timers.phase("graph_creator_prefsuf"):
        g_slots = gcps_graph_sharded(
            mesh, packed_l, lengths, npad, tcfg.min_overlap_pref_suf,
            tcfg.read_length_cap, tcfg.rsoe_min_overlap,
            tcfg.rsoe_number_to_retain, align_from=keep, align_to=keep)
        g = OverlapGraph(n_dense, newid[g_slots.src].astype(np.int32),
                         newid[g_slots.dst].astype(np.int32),
                         g_slots.offset.copy()).sorted_by_src_offset()
        g = g.retain_min_offset()
    _log(f"[distributed] overlap graph: {g.num_edges} edges over "
         f"{n_dense} reads")

    # --- 5: simplification and chain discovery over the mesh ----------------
    shim = _ValidShim(np.ones(n_dense, dtype=bool), lengths_dense)
    with timers.phase("graph_simplifier"):
        shim.valid &= ~g.isolated_nodes()
        g = simplify_graph_old_sharded(
            mesh, g, shim, tcfg.max_offset_parallel_paths,
            tcfg.max_offset_dangling_branches, threads=tcfg.threads,
            log=_log)
    if not shim.valid.any():
        raise pipeline.DataQualityError(
            "No valid nodes after graph simplification, no contig to "
            "extract. Please check the quality of the input data.")
    with timers.phase("contract"):
        def chain_fn(cg_):
            return chain_terminals_sharded(mesh, cg_.to_overlap_graph())[0]
        cg = contract.ContractedGraph(g)
        for _ in range(2):
            cg.retain_min_offset_inplace()
            contract.simplify_contract(cg, tcfg.max_offset_parallel_paths,
                                       log=_log, chain_mask_fn=chain_fn)
        cg.retain_min_offset_inplace()

    # --- 6: contigs on rank 0 -----------------------------------------------
    with timers.phase("gather_store"):
        packed_kept = _gather_packed_to_proc0(mesh, packed_l, keep)
    contigs = []
    if packed_kept is not None:
        batch0 = SeqBatch(packed_kept, lengths_dense.astype(np.int32),
                          shim.valid.copy(), po_dense.copy())
        with timers.phase("contig_creator"):
            reliable = walk.mark_reliable_predecessors(
                cg, batch0, paired=paired,
                avg_read_length=batch0.avg_read_length(),
                min_paired_connections=tcfg.min_paired_connections,
                max_insert_size=tcfg.max_length_of_insert_size)
            contigs = walk.get_all_contigs(
                cg, batch0, tcfg.contig_min_output_length, reliable)
        with timers.phase("consensus"):
            consensus.correct_all(contigs, batch0, device=dev)
        with timers.phase("filter"):
            contigs = output.filter_contigs(
                contigs, n_dense, tcfg.contig_min_output_length,
                tcfg.new_reads_per_contig_percentage)
        if not contigs:
            _log("NO CONTIGS PRODUCED. PLEASE CHECK THE QUALITY OF THE "
                 "INPUT DATA.")
        with timers.phase("trim"):
            output.trim_contigs(contigs, threshold=tcfg.trim_threshold,
                                read_cap=tcfg.read_length_cap, device=dev)
        if write_output:
            output.write_contigs(contigs, cfg.output, rna=cfg.rna)
            _log(f"[distributed] wrote {len(contigs)} contigs to "
                 f"{cfg.output}")
    timers.stop("total")
    stats = timers_mod.contig_stats([len(c) for c in contigs])
    stats["phase_seconds"] = timers.report()
    stats["memory_peaks_mb"] = pipeline.memory_peaks(dev)
    stats["counters"] = timers_mod.counters_report()
    return pipeline.AssemblyResult(contigs, tcfg, timers, stats)
