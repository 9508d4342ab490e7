"""End-to-end assembly (port of alga_tpu/pipeline.py; ref
src/main.cpp:57-779).

Phases: read input → autotune → [correct] → dedup prefix reads → remap →
overlap graph (GCPS, on the device) → [LI supplement, its ACH on the
device] → simplify → contract → contigs → consensus (on the device under
ALGA_DEVICE_CONSENSUS) → filter → trim → write.  The other phases run on
the host: the native engine and its numpy twins, in the port's copy of
alga_tpu's host layer.

With `mesh=` (parallel/mesh.py) every rank of the mesh runs this with
the same inputs: GCPS, the simplification passes and the chain discovery
of the contraction run sharded over the ranks, the ACLER supplement
splits its pairs over them, and the host phases run replicated, so every
rank computes the same contigs.  Without one, `sharded_gcps` decides
whether the GCPS phase alone runs on a mesh (`_gcps_mesh`), as in
alga_tpu.
"""

from __future__ import annotations

import os
import resource
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from alga_tpu_torch import config, corrector, native, store
from alga_tpu_torch import device as device_mod
from alga_tpu_torch.config import AssemblyConfig, TunedConfig
from alga_tpu_torch.contig import consensus, walk
from alga_tpu_torch.graph import contract, prefsuf, simplify
from alga_tpu_torch.graph import supplement as supp
from alga_tpu_torch.graph.overlap_graph import OverlapGraph
from alga_tpu_torch.io import fastx, output
from alga_tpu_torch.utils import serialize
from alga_tpu_torch.utils import timers as timers_mod
from alga_tpu_torch.utils.timers import PhaseTimer


def _log(*a):
    print(*a, file=sys.stderr)


# assembly-level progress (ref MyUtils::writeProgress): one tick per phase
_PIPELINE_STEPS = 10


class _Progress:
    def __init__(self, total: int):
        self.total = total
        self.done = 0

    def tick(self, label: str):
        self.done = min(self.done + 1, self.total)
        timers_mod.write_progress(self.done, self.total, f"assembly:{label}")


def memory_peaks(dev: torch.device) -> dict:
    """Peak host RSS and peak device memory allocated by torch, in MB."""
    peaks = {"rss_mb": round(resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1)}
    peaks["device_mb"] = (round(torch.cuda.max_memory_allocated(dev) / 1e6, 1)
                          if dev.type == "cuda" else 0.0)
    return peaks


class DataQualityError(RuntimeError):
    """No valid reads left after simplification (ref main.cpp:429-435);
    the CLI maps it to the reference's stderr message + exit(1)."""


@dataclass
class AssemblyResult:
    contigs: list
    cfg: TunedConfig
    timers: PhaseTimer
    stats: dict = field(default_factory=dict)


def remap_paired_offsets(batch, paired: bool):
    """Compact invalid reads away keeping the (rc, r) pair structure, and
    build the paired-offset table (ref main.cpp:150-232).  For paired
    input, blocks of 4 keep offsets ±2 when both mate pairs survive."""
    n = len(batch)
    valid_pair = batch.valid[0::2] & batch.valid[1::2]
    keep = np.repeat(valid_pair, 2)
    po = np.zeros(n, dtype=np.int8)
    if paired and n:
        # blocks of 4 slots [r, rc(r), pair(r), rc(pair(r))]; a block gets
        # offsets [1,1,2,2] iff both of its (rc,r) pairs survived
        assert n % 4 == 0, "paired input must arrive in blocks of 4 slots"
        both = valid_pair[0::2] & valid_pair[1::2]
        po.reshape(-1, 4)[both] = np.array([1, 1, 2, 2], dtype=np.int8)
    batch.paired_offset = po
    batch.valid &= keep
    nb, _remap = batch.compact()
    return nb


def _gcps_mesh(cfg: TunedConfig, mesh=None, device=None):
    """(mesh of the GCPS phase or None for one device, whether this call
    made the process group).  A mesh given by the caller wins; "off"
    never shards; "on" makes a mesh even of one rank; "auto" shards when
    the default process group has more than one rank (the counterpart of
    alga_tpu's "more than one accelerator visible")."""
    if mesh is not None or cfg.sharded_gcps == "off":
        return mesh, False
    from alga_tpu_torch.parallel import mesh as mesh_mod
    had_group = torch.distributed.is_initialized()
    if cfg.sharded_gcps == "on" or (
            had_group and torch.distributed.get_world_size() > 1):
        return mesh_mod.make_mesh(device), not had_group
    return None, False


def build_graph_phase(batch, cfg: TunedConfig, timers: PhaseTimer, *,
                      device=None, mesh=None):
    """GCPS graph of the read store on `device`, or sharded over `mesh`,
    after the short-read removal of ref main.cpp:253-266.  A process
    group that `_gcps_mesh` made for this phase is destroyed after it."""
    too_short = batch.lengths < cfg.li_kmer_intervals + cfg.li_kmer_length
    batch.valid &= ~too_short
    if too_short.any():
        _log(f"removed {int(too_short.sum())} reads shorter than "
             f"{cfg.li_kmer_intervals + cfg.li_kmer_length}")
    mesh, made_group = _gcps_mesh(cfg, mesh, device)
    with timers.phase("graph_creator_prefsuf"):
        if mesh is not None:
            from alga_tpu_torch.parallel.sharded_gcps import \
                gcps_graph_sharded
            _log(f"sharded GCPS over {mesh.d} ranks")
            try:
                g = gcps_graph_sharded(
                    mesh, batch.packed, batch.lengths, len(batch),
                    ell_min=cfg.min_overlap_pref_suf,
                    cap=cfg.read_length_cap, rsoe=cfg.rsoe_min_overlap,
                    soes=cfg.soes, align_from=batch.valid,
                    align_to=batch.valid)
            finally:
                if made_group:
                    torch.distributed.destroy_process_group()
        else:
            st = store.to_device(batch, device)
            g = prefsuf.build_gcps_graph(
                st.packed, st.lengths, len(batch),
                ell_min=cfg.min_overlap_pref_suf, cap=cfg.read_length_cap,
                rsoe=cfg.rsoe_min_overlap, soes=cfg.soes,
                align_from=st.valid, align_to=st.valid, device=device)
            del st
    g = g.retain_min_offset()
    _log(f"overlap graph: {g.num_edges} edges over {g.n} reads")
    return g


class SupplementAdj:
    """Adjacency view for the PKB replay: the existing graph's sorted
    (src, dst) keys plus an overlay of edges added or lowered during the
    supplement.  The native replay reads `_keys`, `_offs` and `overlay`;
    the Python replay calls `get_offset` and `add_min` (O(log E) a
    lookup, no dict of the whole graph)."""

    def __init__(self, g):
        self.g = g
        key = g.src.astype(np.int64) * np.int64(g.n) + g.dst
        order = np.argsort(key, kind="stable")
        self._keys = key[order]
        self._offs = g.offset[order]
        self.n = g.n
        self.overlay: dict[int, int] = {}

    def get_offset(self, a, b):
        """The least offset of edge a->b, base or overlay; None if absent."""
        k = a * self.n + b
        cur = self.overlay.get(k)
        p = int(np.searchsorted(self._keys, k))
        if p < len(self._keys) and self._keys[p] == k:
            base = int(self._offs[p])
            return base if cur is None or base < cur else cur
        return cur

    def add_min(self, a, b, offset):
        """Put a->b at `offset` in the overlay unless it holds a lower one."""
        k = a * self.n + b
        cur = self.overlay.get(k)
        if cur is None or offset < cur:
            self.overlay[k] = offset

    def to_graph(self):
        """Original edges + overlay edges, min-offset deduped."""
        if not self.overlay:
            return self.g.retain_min_offset()
        ks = np.fromiter(self.overlay.keys(), dtype=np.int64,
                         count=len(self.overlay))
        os_ = np.fromiter(self.overlay.values(), dtype=np.int32,
                          count=len(self.overlay))
        merged = OverlapGraph(
            self.g.n,
            np.concatenate([self.g.src, (ks // self.n).astype(np.int32)]),
            np.concatenate([self.g.dst, (ks % self.n).astype(np.int32)]),
            np.concatenate([self.g.offset, os_]))
        return merged.retain_min_offset()


def run_supplement(g, batch, tcfg: TunedConfig, *, device=None, mesh=None):
    """LI/PKB supplement wiring (ref main.cpp:300-355): indeg==0&&outdeg>0
    gets alignTo, indeg>0&&outdeg==0 gets alignFrom; parameters re-tuned
    by supplement_retune."""
    indeg = g.in_degrees()
    outdeg = g.out_degrees()
    align_to = (indeg == 0) & (outdeg > 0)
    align_from = (indeg > 0) & (outdeg == 0)
    scfg = config.supplement_retune(tcfg, batch.avg_read_length())
    adapter = SupplementAdj(g)
    supp.pkb_supplement(adapter, None, batch.lengths, batch.lengths, scfg,
                        align_from, align_to, packed=batch.packed,
                        device=device, mesh=mesh)
    out = adapter.to_graph()
    _log(f"supplement: {out.num_edges - g.num_edges:+d} edges")
    return out


def assemble(cfg: AssemblyConfig, file1_seqs: list[str] | None = None,
             file2_seqs: list[str] | None = None, *, batch=None,
             paired: bool | None = None, device=None,
             mesh=None) -> AssemblyResult:
    """End-to-end assembly with the device phases on `device` (CUDA when
    None; raises without it), or sharded over `mesh` (see `_gcps_mesh`
    and the module docstring).  `batch`/`paired` inject a pre-built
    SeqBatch."""
    dev = mesh.device if mesh is not None else device_mod.resolve(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    timers = PhaseTimer()
    timers.start("total")
    timers_mod.reset_counters()
    prog = _Progress(_PIPELINE_STEPS)

    # --- input ------------------------------------------------------------
    with timers.phase("input_reader"):
        pre_kw = dict(
            trim_left=cfg.read_end_trim_left,
            trim_right=cfg.read_end_trim_right,
            remove_reads_with_n=cfg.remove_reads_with_n,
            rna=cfg.rna,
            str_period=cfg.str_period_threshold,
        )
        if batch is not None:
            paired_input = bool(paired)
        elif file1_seqs is None:
            paired_input = bool(cfg.file2)
            batch = fastx.load_read_batch(
                cfg.file1, cfg.file2 or None,
                add_paired_reads=cfg.add_paired_reads, **pre_kw)
        else:
            paired_input = bool(file2_seqs)
            batch = fastx.build_read_batch(file1_seqs, file2_seqs, **pre_kw)
    prog.tick("input")
    _log(f"{batch.count_valid()} valid reads of {len(batch)} slots")
    _lens = np.asarray(batch.lengths)[batch.valid]
    if len(_lens):
        timers_mod.STREAMING.add_array("read_length", _lens)
        _log(f"read lengths: min={int(_lens.min())} "
             f"avg={float(_lens.mean()):.2f} max={int(_lens.max())}; "
             f"{int((~batch.valid).sum())} slots dropped (N/STR filters)")

    # --- autotune (ref main.cpp:93-115) ------------------------------------
    tcfg = config.autotune(cfg, batch.avg_read_length())
    _log("config: " + " ".join(
        f"{k}={v}" for k, v in sorted(vars(tcfg).items())
        if not k.startswith("_") and k not in ("file1", "file2", "output")))
    _log(f"autotuned: LEN={tcfg.avg_read_length} "
         f"min_overlap={tcfg.min_overlap_pref_suf} rsoe={tcfg.rsoe_min_overlap}")

    # --- optional read correction (ref main.cpp:122-127) --------------------
    if tcfg.correct_reads:
        with timers.phase("read_corrector"):
            nchanged = corrector.correct_reads_batch(batch)
        _log(f"read corrector changed {nchanged} reads")
        if tcfg.correct_reads == 2:
            prefix = tcfg.output.rsplit(".", 1)[0] + "_algacorrect"
            output.write_corrected_fasta(batch, paired_input, prefix)
            _log(f"corrected reads written to {prefix}_{{1,2}}.fasta")
            timers.stop("total")
            return AssemblyResult([], tcfg, timers, {"corrected": nchanged})

    # --- duplicate / prefix read removal -----------------------------------
    with timers.phase("read_preprocess"):
        marked = fastx.mark_prefix_reads(batch)
        batch.valid &= ~marked
    prog.tick("preprocess")
    _log(f"{int(marked.sum())} prefix/duplicate reads removed")

    # --- remap to dense ids -------------------------------------------------
    with timers.phase("remap"):
        batch = remap_paired_offsets(batch, paired=paired_input)
    prog.tick("remap")
    _log(f"{len(batch)} reads after remap")

    # --- overlap graph (with optional checkpoint, ref main.cpp:242-296) -----
    ck_prefix = tcfg.checkpoint_prefix or tcfg.output.rsplit(".", 1)[0]
    ck_before = f"{ck_prefix}_beforeSimplifier.graph"
    if tcfg.deserialize_graph and os.path.exists(ck_before):
        g = serialize.read_reference_graph(ck_before)
        _log(f"deserialized graph from {ck_before}: {g.num_edges} edges")
    else:
        g = build_graph_phase(batch, tcfg, timers, device=dev, mesh=mesh)
        if tcfg.serialize_graph:
            serialize.write_reference_graph(g, ck_before)
            _log(f"serialized graph to {ck_before}")
    prog.tick("graph")

    # --- error-tolerant LI/PKB supplement (ref main.cpp:300-355) ------------
    if tcfg.use_supplement:
        with timers.phase("graph_creator_supplement"):
            g = run_supplement(g, batch, tcfg, device=dev, mesh=mesh)

    batch.valid &= ~g.isolated_nodes()          # ref main.cpp:358-359

    # --- simplify + contract + walk ----------------------------------------
    use_native = cfg.use_native and native.available() and mesh is None
    ck_after = (f"{ck_prefix}_mopp{tcfg.max_offset_parallel_paths}"
                f"_modb{tcfg.max_offset_dangling_branches}"
                f"_rsoe{tcfg.rsoe_min_overlap}-{tcfg.rsoe_number_to_retain}"
                f"_afterSimplifier.graph")
    if tcfg.deserialize_graph and os.path.exists(ck_after):
        g = serialize.read_reference_graph(ck_after)
        batch.valid &= ~g.isolated_nodes()
        _log(f"deserialized simplified graph from {ck_after}")
    else:
        with timers.phase("graph_simplifier"):
            if mesh is not None:
                from alga_tpu_torch.parallel.sharded_simplify import \
                    simplify_graph_old_sharded
                g = simplify_graph_old_sharded(
                    mesh, g, batch, tcfg.max_offset_parallel_paths,
                    tcfg.max_offset_dangling_branches, threads=tcfg.threads,
                    log=_log)
            elif use_native:
                g = native.simplify_graph_old(
                    g, batch, tcfg.max_offset_parallel_paths,
                    tcfg.max_offset_dangling_branches, threads=tcfg.threads)
            else:
                if g.n > 100_000:
                    _log("WARNING: native engine unavailable — the Python "
                         "twin simplifier walks nodes in Python loops and "
                         f"will be very slow at {g.n} nodes (build "
                         "native/libalga_host.so, or run on a mesh)")
                g = simplify.simplify_graph_old(
                    g, batch, tcfg.max_offset_parallel_paths,
                    tcfg.max_offset_dangling_branches, log=_log,
                    threads=tcfg.threads)
        if tcfg.serialize_graph:
            serialize.write_reference_graph(g, ck_after)
    prog.tick("simplify")
    _log(f"post-simplifier degree stats: {g.degree_stats()}")
    _log(f"There are {batch.count_valid()} reads after graph simplification")
    if batch.count_valid() == 0:
        raise DataQualityError(
            "No valid nodes after graph simplification, no contig to "
            "extract. Please check the quality of the input data.")

    if use_native:
        with timers.phase("contract_walk_native"):
            read_lists = native.contract_and_walk(
                g, batch, tcfg.max_offset_parallel_paths,
                tcfg.contig_min_output_length, paired=paired_input,
                min_paired_connections=tcfg.min_paired_connections,
                max_insert_size=tcfg.max_length_of_insert_size,
                threads=tcfg.threads)
            contigs = [walk.Contig(i, "", rl)
                       for i, rl in enumerate(read_lists)]
    else:
        with timers.phase("contract"):
            # ref main.cpp:412-429: contract loop, then a final
            # retainOnlySmallestOffset fixes walk-time adjacency order;
            # on a mesh the chain nodes are found by pointer doubling
            chain_fn = None
            if mesh is not None:
                from alga_tpu_torch.parallel.sharded_contract import \
                    chain_terminals_sharded

                def chain_fn(cg_):
                    return chain_terminals_sharded(
                        mesh, cg_.to_overlap_graph())[0]
            cg = contract.ContractedGraph(g)
            for _ in range(2):
                cg.retain_min_offset_inplace()
                contract.simplify_contract(
                    cg, tcfg.max_offset_parallel_paths, log=_log,
                    chain_mask_fn=chain_fn)
            cg.retain_min_offset_inplace()
        with timers.phase("contig_creator"):
            reliable = walk.mark_reliable_predecessors(
                cg, batch, paired=paired_input,
                avg_read_length=batch.avg_read_length(),
                min_paired_connections=tcfg.min_paired_connections,
                max_insert_size=tcfg.max_length_of_insert_size)
            contigs = walk.get_all_contigs(
                cg, batch, tcfg.contig_min_output_length, reliable)
    prog.tick("walk")
    _log(f"{len(contigs)} contigs before filtering")

    with timers.phase("consensus"):
        consensus.correct_all(contigs, batch, device=dev)
    prog.tick("consensus")
    with timers.phase("filter"):
        contigs = output.filter_contigs(
            contigs, len(batch), tcfg.contig_min_output_length,
            tcfg.new_reads_per_contig_percentage)
    prog.tick("filter")
    _log(f"{len(contigs)} contigs after filtering")
    if not contigs:
        _log("NO CONTIGS PRODUCED. PLEASE CHECK THE QUALITY OF THE "
             "INPUT DATA.")

    with timers.phase("trim"):
        output.trim_contigs(contigs, threshold=tcfg.trim_threshold,
                            read_cap=tcfg.read_length_cap, device=dev)
    prog.tick("trim")
    prog.tick("done")
    timers.stop("total")
    stats = timers_mod.contig_stats([len(c) for c in contigs])
    stats["phase_seconds"] = timers.report()
    stats["memory_peaks_mb"] = memory_peaks(dev)
    stats["counters"] = timers_mod.counters_report()
    timers_mod.STREAMING.add_array("contig_length", [len(c) for c in contigs])
    stats["streaming"] = timers_mod.STREAMING.report()
    stats["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else str(dev))
    timers_mod.emit_metrics(stats)
    return AssemblyResult(contigs, tcfg, timers, stats)


def assemble_to_file(cfg: AssemblyConfig, **kw) -> AssemblyResult:
    res = assemble(cfg, **kw)
    output.write_contigs(res.contigs, cfg.output, rna=cfg.rna)
    _log(f"wrote {len(res.contigs)} contigs to {cfg.output}")
    return res
