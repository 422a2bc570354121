"""End-to-end preprocessing: C source -> model-ready GraphSpec (the port's
copy of the reference's `deepdfa_tpu/data/pipeline.py`).

Mirrors the reference pipeline stages (DDFA/scripts/preprocess.sh):
  prepare (clean + line labels) -> getgraphs (CPG extraction) ->
  dbize (node/edge tables) -> abstract_dataflow (stage 1+2) ->
  dbize_absdf (vocab indexing)
but runs hermetically on the built-in frontend, in-process, with
multiprocessing fan-out for corpus-scale extraction.

The model graph is the reference's: CPG nodes that carry a line number and
participate in CFG edges, reindexed densely (feature_extraction,
DDFA/sastvd/linevd/utils.py:28-76 with graph_type="cfg"); per-node vuln
labels come from changed-line sets (dbize.py:35-50); self-loops are added
at batch time (dbize_graphs.py:25).

`struct_feats` appends the five structural channels of
`frontend/structfeat.py` after the four subkey columns. `max_defs`
attaches the reaching-definitions bit labels of that width
(`nn/bitprop.py:rd_bit_problem`, solved over the full CFG and remapped
onto the kept nodes) for the dataflow_solution_{in,out} label styles.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from multiprocessing import Pool
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

from deepdfa_tpu_torch.core.config import GTYPE_ETYPES
from deepdfa_tpu_torch.data.examples import Example
from deepdfa_tpu_torch.frontend import (
    absdf,
    parser as cparser,
)
from deepdfa_tpu_torch.frontend.cpg import CFG, Cpg
from deepdfa_tpu_torch.frontend.vocab import AbsDfVocab, Fields, build_vocabs
from deepdfa_tpu_torch.graphs.batch import GraphSpec
from deepdfa_tpu_torch.nn.embedding import SUBKEY_ORDER


@dataclasses.dataclass
class ExtractedGraph:
    """Host-side intermediate: one function's model graph + features."""

    graph_id: int
    node_lines: np.ndarray  # [n] int32 source line per node
    edge_src: np.ndarray  # [e] int32 (CFG, no self loops)
    edge_dst: np.ndarray
    def_fields: dict[int, Fields]  # dense node idx -> stage-1 fields
    label: float  # function-level label
    #: optional reaching-definitions bit labels ([n, max_defs] float32 each:
    #: gen/kill/in/out) for the dataflow_solution_{in,out} label styles
    bits: dict[str, np.ndarray] | None = None
    #: per-edge relation ids (gtype="cfg+dep": 0=cfg, 1=data-dependence,
    #: 2=control-dependence); None for single-type cfg graphs
    edge_type: np.ndarray | None = None
    #: optional [n, NUM_STRUCT_FEATS] family-invariant structural channels
    #: (frontend/structfeat.py) appended to node_feats by to_graph_spec
    struct: np.ndarray | None = None

    @property
    def num_nodes(self) -> int:
        return int(self.node_lines.shape[0])


def extract_graph(
    code: str,
    graph_id: int,
    vuln_lines: set[int] | None = None,
    label: float | None = None,
    max_defs: int | None = None,
    gtype: str = "cfg",
    struct_feats: bool = False,
) -> ExtractedGraph | None:
    """Parse one function and build its model graph. None on failure or
    empty CFG (reference behavior: failures are skipped and logged,
    getgraphs.py:57-59).

    gtype selects the edge relations (the reference's gtype/rdg experiment
    axis, DDFA/sastvd/helpers/joern.py:419-441):
    - "cfg" (flagship): control-flow edges, single relation
    - "pdg": program-dependence graph — data + control dependences merged
      into ONE relation (the reference's rdg("pdg") reduction)
    - "cfg+dep": cfg (type 0) + data-dependence (1) + control-dependence
      (2) as typed edges for an n_etypes=3 GGNN
    """
    # validate BEFORE parsing: a bad gtype must fail fast on the first
    # call, not only on the subset of a corpus that happens to parse
    if gtype not in GTYPE_ETYPES:
        raise ValueError(f"gtype={gtype!r}")
    try:
        cpg = cparser.parse_function(code)
    except ValueError:
        return None
    return graph_from_cpg(
        cpg, graph_id, vuln_lines, label=label, max_defs=max_defs,
        gtype=gtype, struct_feats=struct_feats,
    )


def graph_from_cpg(
    cpg: Cpg,
    graph_id: int,
    vuln_lines: set[int] | None = None,
    label: float | None = None,
    max_defs: int | None = None,
    gtype: str = "cfg",
    struct_feats: bool = False,
) -> ExtractedGraph | None:
    """Model graph + features from an already-built CPG.

    The parser-independent half of `extract_graph`: the built-in parser
    and the Joern-backed serving frontend (serve/frontend.py, via
    frontend/joern_io.py:load_joern_cpg) both land here, so their
    features are computed by the same code."""
    if gtype not in GTYPE_ETYPES:
        raise ValueError(f"gtype={gtype!r}")

    keep = [
        nid
        for nid in cpg.cfg_nodes()
        if cpg.nodes[nid].line is not None
    ]
    if not keep:
        return None
    dense = {nid: i for i, nid in enumerate(keep)}
    keep_set = set(keep)

    node_lines = np.array([cpg.nodes[nid].line for nid in keep], np.int32)
    src, dst, typ = [], [], []
    if gtype != "pdg":
        for s, d, t in cpg.edges:
            if t == CFG and s in keep_set and d in keep_set:
                src.append(dense[s])
                dst.append(dense[d])
                typ.append(0)
    edge_type = None
    if gtype in ("pdg", "cfg+dep"):
        from deepdfa_tpu_torch.frontend import deps as deps_mod

        # pdg merges both dependence kinds into one relation; cfg+dep
        # keeps them typed alongside cfg
        for tid, pairs in (
            (1, deps_mod.data_dependences(cpg)),
            (2, deps_mod.control_dependences(cpg)),
        ):
            for s, d in sorted(pairs):
                if s in keep_set and d in keep_set:
                    src.append(dense[s])
                    dst.append(dense[d])
                    typ.append(tid if gtype == "cfg+dep" else 0)
        if gtype == "cfg+dep":
            edge_type = np.array(typ, np.int32)
    def_fields: dict[int, Fields] = {}
    for nid in keep:
        if absdf.is_decl(cpg, nid):
            fields = absdf.decl_features(cpg, nid)
            if fields:
                def_fields[dense[nid]] = fields

    bits = None
    if max_defs is not None:
        # reaching-definitions supervision over the FULL CFG, remapped onto
        # the kept (line-bearing) nodes; graphs with zero definition sites
        # get all-zero arrays so the corpus stays fixed-width
        from deepdfa_tpu_torch.nn.bitprop import rd_bit_problem

        prob = rd_bit_problem(cpg, max_defs, clip=True)
        n_keep = len(keep)
        bits = {
            k: np.zeros((n_keep, max_defs), np.float32)
            for k in ("gen", "kill", "labels_in", "labels_out")
        }
        if prob is not None:
            full_dense = {nid: i for i, nid in enumerate(prob["nodes"])}
            rows = np.array([full_dense.get(nid, -1) for nid in keep], np.int64)
            ok = rows >= 0
            for k in bits:
                bits[k][ok] = prob[k][rows[ok]]

    if label is None:
        label = (
            1.0
            if vuln_lines and any(int(l) in vuln_lines for l in node_lines)
            else 0.0
        )
    struct = None
    if struct_feats:
        from deepdfa_tpu_torch.frontend.structfeat import struct_features

        struct = struct_features(cpg, keep)
    return ExtractedGraph(
        graph_id=graph_id,
        node_lines=node_lines,
        edge_src=np.array(src, np.int32),
        edge_dst=np.array(dst, np.int32),
        def_fields=def_fields,
        label=float(label),
        bits=bits,
        edge_type=edge_type,
        struct=struct,
    )


def to_graph_spec(
    eg: ExtractedGraph,
    vocabs: Mapping[str, AbsDfVocab],
    vuln_lines: set[int] | None = None,
) -> GraphSpec:
    """Encode features through the vocab and emit the batchable GraphSpec."""
    from deepdfa_tpu_torch.frontend.vocab import encode_nodes

    n = eg.num_nodes
    feats = encode_nodes(vocabs, eg.def_fields, range(n), SUBKEY_ORDER)
    if eg.struct is not None:
        # struct channels ride as extra columns; the embedding splits
        # them back out by position (nn/embedding.py struct_vocab)
        feats = np.concatenate([feats, eg.struct], axis=1)
    if vuln_lines:
        vuln = np.array(
            [1 if int(l) in vuln_lines else 0 for l in eg.node_lines], np.int32
        )
    else:
        vuln = np.zeros((n,), np.int32)  # graph label carried separately
    bit_kw = {}
    if eg.bits is not None:
        bit_kw = dict(
            node_gen=eg.bits["gen"],
            node_kill=eg.bits["kill"],
            node_bits_in=eg.bits["labels_in"],
            node_bits_out=eg.bits["labels_out"],
        )
    return GraphSpec(
        graph_id=eg.graph_id,
        node_feats=feats,
        node_vuln=vuln,
        edge_src=eg.edge_src,
        edge_dst=eg.edge_dst,
        label=eg.label,
        edge_type=eg.edge_type,
        **bit_kw,
    )


def _extract_one(
    ex: Example, max_defs: int | None = None, gtype: str = "cfg",
    struct_feats: bool = False,
) -> ExtractedGraph | None:
    try:
        return extract_graph(
            ex.code, ex.id, set(ex.vuln_lines) or None, label=ex.label,
            max_defs=max_defs, gtype=gtype, struct_feats=struct_feats,
        )
    except Exception:
        # corpus-scale resilience: one pathological function must never
        # kill a 188k-example run (the reference skips and logs failures,
        # getgraphs.py:57-59); extract_graph handles parse errors itself,
        # this guards against anything unexpected deeper in the pipeline
        import logging
        import traceback

        logging.getLogger(__name__).warning(
            "extraction failed for example %s:\n%s", ex.id, traceback.format_exc()
        )
        return None


def extract_corpus(
    examples: Sequence[Example], workers: int = 0,
    max_defs: int | None = None, gtype: str = "cfg",
    struct_feats: bool = False,
) -> list[ExtractedGraph]:
    """Stage getgraphs+absdf-stage-1 over a corpus (mp fan-out like the
    reference's dfmp, sastvd/__init__.py:198-244)."""
    fn = partial(_extract_one, max_defs=max_defs, gtype=gtype,
                 struct_feats=struct_feats)
    if workers and workers > 1:
        with Pool(workers) as pool:
            out = pool.map(fn, examples, chunksize=64)
    else:
        out = [fn(ex) for ex in examples]
    return [g for g in out if g is not None]


def build_corpus_vocabs(
    examples: Sequence[Example],
    train_ids: Iterable[int],
    limit_all: int | None = 1000,
    limit_subkeys: int | None = 1000,
    workers: int = 0,
) -> dict[str, AbsDfVocab]:
    """Stage 1+2 over the TRAIN split only -> the shared vocabularies.

    This is the reference's abstract_dataflow stage ordering: the vocab is
    a corpus-level artifact built once before per-graph encoding, so
    sharded extraction jobs all encode against identical vocabularies."""
    train = set(train_ids)
    train_examples = [ex for ex in examples if ex.id in train]
    graphs = extract_corpus(train_examples, workers=workers)
    train_fields = [f for g in graphs for f in g.def_fields.values()]
    return build_vocabs(
        train_fields, SUBKEY_ORDER, limit_all=limit_all, limit_subkeys=limit_subkeys
    )


def encode_corpus(
    examples: Sequence[Example],
    vocabs: Mapping[str, AbsDfVocab],
    workers: int = 0,
    max_defs: int | None = None,
    gtype: str = "cfg",
    struct_feats: bool = False,
) -> list[GraphSpec]:
    """Extract + encode a corpus slice against pre-built vocabularies."""
    graphs = extract_corpus(
        examples, workers=workers, max_defs=max_defs, gtype=gtype,
        struct_feats=struct_feats,
    )
    by_id = {ex.id: ex for ex in examples}
    return [
        to_graph_spec(g, vocabs, set(by_id[g.graph_id].vuln_lines) or None)
        for g in graphs
    ]


def build_dataset(
    examples: Sequence[Example],
    train_ids: Iterable[int],
    limit_all: int | None = 1000,
    limit_subkeys: int | None = 1000,
    workers: int = 0,
    max_defs: int | None = None,
    gtype: str = "cfg",
    struct_feats: bool = False,
) -> tuple[list[GraphSpec], dict[str, AbsDfVocab]]:
    """Full single-process pipeline: extract, build train-split vocabs,
    encode everything. `max_defs` attaches reaching-definitions bit labels
    of that width for the dataflow_solution_{in,out} label styles;
    `gtype` selects the edge-relation set (see extract_graph)."""
    graphs = extract_corpus(
        examples, workers=workers, max_defs=max_defs, gtype=gtype,
        struct_feats=struct_feats,
    )
    train = set(train_ids)
    train_fields = [
        f
        for g in graphs
        if g.graph_id in train
        for f in g.def_fields.values()
    ]
    vocabs = build_vocabs(
        train_fields, SUBKEY_ORDER, limit_all=limit_all, limit_subkeys=limit_subkeys
    )
    by_id = {ex.id: ex for ex in examples}
    specs = [
        to_graph_spec(g, vocabs, set(by_id[g.graph_id].vuln_lines) or None)
        for g in graphs
    ]
    return specs, vocabs
