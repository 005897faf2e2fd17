"""Typed configuration for every pipeline stage.

Replaces the reference's two-level config (shell cfg file eval'd line by line,
`scripts/lesv.sh:26-28`, plus per-binary NCBI CArgDescriptions flags,
`app/map/cmdline_args.cpp`) with plain dataclasses.  Defaults mirror the
reference's published defaults (file:line cited per field).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class SplitConfig:
    """Subread splitting (reference `app/split_seq/main.c:28-45`)."""

    max_subseq_size: int = 50_000      # MAX_SUBSEQ_SIZE
    min_last_subseq_size: int = 20_000  # last piece merged into previous if smaller
    overlap_size: int = 0               # default 0 in x_hqx2splitseq.sh


@dataclass
class IndexConfig:
    """Reference k-mer index (reference `app/map/cmdline_args.cpp:36-41`)."""

    kmer_size: int = 15        # -kmer_size
    kmer_window: int = 10      # -kmer_window (stride of sampled kmers)
    max_kmer_occ: int = 200    # -max_kmer_occ (drop over-occurring kmers)


@dataclass
class SeedingConfig:
    """Query-side sparse windowed seeding (reference `hbn_word_finder.c:8-9`)."""

    seeding_seq_size: int = 300    # kSeedingSeqSize: seeded window length
    seeding_seq_stride: int = 200  # kSeedingSeqStride: gap between windows
    # query k-mers are sampled at stride 1 within each window — the
    # reference HARDCODES window=1 for the word finder
    # (`hbn_align_one_volume.c:125-130`); -kmer_window only sparsifies
    # the subject index.  Stride-1 query sampling is what defeats the
    # index's phase grid for indel-free stretches.
    query_stride: int = 1
    max_query_kmer_occ: int = 200  # skip query kmers hitting > this many subject pos


@dataclass
class ChainConfig:
    """minimap2-style chain DP (reference `chain_dp.c:39-57`)."""

    max_dist_qry: int = 5_000
    max_dist_ref: int = 5_000
    max_band_width: int = 1_500
    min_seed_cnt: int = 3        # min_ddfs (`cmdline_args.cpp:44`)
    # DDF stage min score = min_ddfs * kmer_size * 0.8
    # (`chain_and_extend_kmer_matches.c:59`)
    min_chain_score: int = 36
    # chain joining — what lets an SV-spanning read stay one candidate
    max_join_long: int = 20_000
    max_join_short: int = 2_000
    # kMinMemLen / kMinMemScore (`chain_dp.c:414-444`): both flanks of a
    # join must be >= this long / this strong
    min_join_flank_len: int = 1_000
    min_join_flank_score: int = 500
    max_chains_per_context: int = 40
    # device chain DP (ops/chain_jax.py): predecessor lookback depth —
    # replaces the reference's max_skip=25 pruning heuristic
    lookback: int = 64


@dataclass
class AlignConfig:
    """Extension / alignment engine (ksw2_extd2 params, `ksw2_wrapper.c:72-95`)."""

    match: int = 2
    mismatch: int = 5           # penalty (positive magnitude)
    gap_open1: int = 5
    gap_ext1: int = 4
    gap_open2: int = 56
    gap_ext2: int = 1
    end_match_len: int = 8       # kMatLen: alignments begin/end with 8bp exact match
    eff_ident_gap_run: int = 20  # gap runs >= this are excluded from effective identity
    # segment bucketing for the batched DP kernel
    seg_len: int = 256           # nominal inter-anchor segment length cap
    max_band: int = 2_048


@dataclass
class MapConfig:
    """Mapper output filters (reference `app/map/cmdline_args.cpp:60-90`)."""

    qcov_hsp_res: int = 100        # min aligned query residues
    perc_identity: float = 0.0     # min identity percent to report
    max_target_seqs: int = 5       # max subjects per query
    max_hsps: int = 5              # max HSPs per subject window
    max_subseq_gap_merge: int = 500    # merge candidate windows <=500bp apart
    subseq_margin_factor: float = 1.3  # window = 1.3x qlen (`hbn_find_subseq_hit.c:119-156`)
    subseq_max_gap: int = 30_000       # +<=30kb margin
    min_query_size: int = 0
    # out-of-core volume partitioning (reference `app/map/main.c:40-70`,
    # `makehbndb.c:20-26`): subject volumes bound index memory; query
    # batching bounds in-flight seed-match memory
    max_subject_vol_res: int = 4_000_000_000   # -max_subject_vol_res (4g)
    max_query_vol_res: int = 4_000_000_000     # -max_query_vol_res
    query_batch_size: int = 500_000_000        # -query_batch_size (500m)
    # reads per map_batch: large batches amortize per-dispatch transport
    # (inner device calls chunk at 64 reads / pairs regardless)
    batch_reads: int = 512
    # seeding/chaining engine: "device" (batched JAX kernels,
    # ops/{seeding,chain,pairseed}_jax) or "host" (per-read numpy oracle)
    engine: str = "device"
    # per-lane match-slot budgets for the device expansion; lanes whose
    # true match count exceeds the budget fall back to the host oracle
    # (stride-1 query sampling: a 50kb read at ONT error rates yields
    # ~5k matches; near-perfect reads can overflow and fall back)
    seed_match_budget: int = 16384
    pair_match_budget: int = 8192


@dataclass
class MemScConfig:
    """Second-stage (memsc) pairwise re-seeding inside candidate windows
    (reference `init_hit_finder.c:26-27`, defaults
    `app/map/cmdline_args.cpp:48-57`)."""

    kmer_size: int = 10      # -memsc_kmer_size (kDfltMemScKmerSize)
    kmer_window: int = 10    # -memsc_kmer_window (query-side stride)
    mem_score: int = 30      # -memsc_mem_score (min chain score)
    mem_size: int = 15       # -memsc_mem_size (min maximal-match length)
    max_occ: int = 8         # kMaxWordOcc / kMaxSeedOcc
    skip_memsc: bool = False  # -skip_memsc: extend straight from DDF chains


@dataclass
class SvReadConfig:
    """SV-read selection (stage qx2svr; `lesv.sh:133-152` positional args)."""

    min_seq_size: int = 3_000        # SVR_MIN_SEQ_SIZE
    min_ident_perc: float = 70.0     # SVR_MIN_SVE_PERC_IDENTITY
    max_overhang: int = 300          # SVR_MAX_OVERHANG
    dual_max_subject_gap: int = 30_000   # `find_sv_reads.c:432-456` (two_m4s_are_dual)
    contained_eps: int = 200         # `remove_contained_m4s` E
    repeat_eps: int = 300            # `remove_repeat_m4s` E
    best_ident_margin: float = 10.0  # best complete m4 must beat 2nd by > 10
    dual_ident_margin: float = 4.0   # chained dual eff ident within 4 of parts


@dataclass
class SvSigConfig:
    """Signature extraction (stage qx2svsig; `find_sv_signature.c`)."""

    min_indel_size: int = 40         # SVSIG_MIN_INDEL_SIZE
    min_eff_ident_perc: float = 70.0  # `find_sv_signature.c:347`
    band_factor: float = 1.2         # band = dist * 1.2, rescue with full band


@dataclass
class GroupConfig:
    """Signature clustering (reference `find_one_sv_group.cpp:10-18`)."""

    window: int = 10
    min_cnt: int = 4
    max_dist: int = 20
    window_relax: int = 50
    min_cnt_relax: int = 4
    max_len_diff: int = 50
    max_len_diff_ratio: float = 0.1


@dataclass
class CnsConfig:
    """Group consensus (reference `cns_one_group.c`, `cmdline_args.cpp:39-40`)."""

    cns1_perc_identity: float = 65.0
    cns2_perc_identity: float = 85.0
    max_cns_cov: int = 15        # MAX_CNS_COV `cns_one_group.c:13`
    min_cov: int = 3
    min_size: int = 2_000
    indel_cov_factor: float = 0.4   # fccns INDEL_COV_FACTOR
    cns_weight: float = 1.0         # DEFAULT_CNS_WEIGHT
    max_delta: int = 63             # cap on insertion-run delta in tag tensors


@dataclass
class RemapConfig:
    """Consensus-read remapping (stage qx2asvr; `map_cns_sv_read.c`)."""

    band_factor: float = 0.2         # distance = 0.2 x max(len)
    min_eff_ident_perc: float = 85.0  # `map_cns_sv_read.c:145`


@dataclass
class CallConfig:
    """Native SV caller (replaces pbsv discover/call, `x_hqx2callsv.sh`)."""

    min_sig_len: int = 20        # pbsv discover -l 20
    max_ins_length: int = 30_000  # pbsv call --max-ins-length 30k
    min_support: int = 3          # pbsv call -A/-O default
    min_support_frac: float = 0.2  # support must be >= this x local depth
    # genotype 1/1 when support >= this x raw local depth; support
    # systematically undercounts (flank + consensus filters drop ~25-40%
    # of true-allele reads), so the hom/het boundary sits well below the
    # naive 0.75 allele fraction
    hom_genotype_frac: float = 0.55
    cluster_dist: int = 1_000
    cluster_len_ratio: float = 0.25
    min_sv_len: int = 30          # emitted SVs must be >= this (pbsv default)


@dataclass
class LesvConfig:
    """Top-level pipeline configuration."""

    split: SplitConfig = field(default_factory=SplitConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    seeding: SeedingConfig = field(default_factory=SeedingConfig)
    chain: ChainConfig = field(default_factory=ChainConfig)
    align: AlignConfig = field(default_factory=AlignConfig)
    map: MapConfig = field(default_factory=MapConfig)
    memsc: MemScConfig = field(default_factory=MemScConfig)
    sv_read: SvReadConfig = field(default_factory=SvReadConfig)
    sv_sig: SvSigConfig = field(default_factory=SvSigConfig)
    group: GroupConfig = field(default_factory=GroupConfig)
    cns: CnsConfig = field(default_factory=CnsConfig)
    remap: RemapConfig = field(default_factory=RemapConfig)
    call: CallConfig = field(default_factory=CallConfig)
    num_threads: int = 0   # host worker threads for IO; 0 = auto

    def replace(self, **kw) -> "LesvConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def ultra_long(cls) -> "LesvConfig":
        """Preset for ultra-long reads (reference README.md:149-172)."""
        cfg = cls()
        cfg.index.kmer_size = 19
        cfg.index.kmer_window = 20
        cfg.sv_read.min_ident_perc = 80.0
        return cfg
