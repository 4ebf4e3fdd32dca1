"""The port's persistent shard-store against the reference's, on the CPU.

Both packages write and read the same directory layout (index/store.py), so
a store written by either loads in the other: decodes, codec tags, sizes and
payloads equal, exactly.  The two packages' saves of the same engine are
byte-identical in every ``.bin`` file, and their ``meta.json`` and
``shards.json`` equal as parsed JSON (key order may differ).  Engines
started from one store give equal Boolean results and ranked top-k in both
packages.  Inputs are made with numpy from a seed.
"""
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import LearnedIndexConfig as RefLIConfig
from repro.core.learned_bloom import LearnedBloom as RefLearnedBloom
from repro.index import store as ref_store
from repro.index.build import InvertedIndex as RefInvertedIndex
from repro.index.build import slice_index as ref_slice_index
from repro.postings.hybrid import HybridPostings as RefHybridPostings
from repro.rank.score import ImpactModel as RefImpactModel
from repro.rank.score import brute_force_topk as ref_brute_force_topk
from repro.serve import BooleanEngine as RefEngine, ServeConfig as RefServeConfig
from repro_torch.common.config import CorpusConfig, LearnedIndexConfig
from repro_torch.core.learned_bloom import fit_thresholds
from repro_torch.core.membership import params_from_jax
from repro_torch.data.corpus import synthesize_corpus
from repro_torch.data.queries import brute_force_answers, sample_queries, zipf_disjunctions
from repro_torch.index import store
from repro_torch.index.build import InvertedIndex, build_inverted_index, slice_index
from repro_torch.launch.serve import main as serve_main
from repro_torch.postings import search
from repro_torch.postings.hybrid import HybridPostings
from repro_torch.rank.score import ImpactModel, brute_force_topk
from repro_torch.serve import BooleanEngine, ServeConfig

UNIVERSE = 6000
RANGES = [(0, 2016), (2016, 2016), (2016, UNIVERSE)]  # the middle shard is empty
PACKAGES = {
    "port": (InvertedIndex, slice_index, HybridPostings, store),
    "ref": (RefInvertedIndex, ref_slice_index, RefHybridPostings, ref_store),
}


def _mixed_lists(rng, universe=UNIVERSE):
    """Lists that exercise several codecs: runs and smooth lists (learned
    codecs win), rough and dense random lists, a tiny and an empty list."""
    lists = [
        np.arange(100, 1700, 4),
        np.arange(300) * 17 + rng.integers(0, 4, 300),
        np.arange(2100, 5900, 3),
        np.sort(rng.choice(universe, 60, replace=False)),
        np.sort(rng.choice(universe, 5000, replace=False)),
        np.sort(rng.choice(universe, 900, replace=False)),
        np.array([5, 900, 4000]),
        np.zeros(0),
    ]
    return [np.unique(x).astype(np.int32) for x in lists]


def _sharded(pkg: str, seed: int = 7):
    """One collection in package ``pkg``: the shard entries over RANGES, each
    store with 8-bit payloads from the seed."""
    inv_cls, slicer, hybrid, _ = PACKAGES[pkg]
    rng = np.random.default_rng(seed)
    lists = _mixed_lists(rng)
    offsets = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(x) for x in lists], out=offsets[1:])
    doc_ids = np.concatenate(lists)
    tfs = rng.integers(1, 9, len(doc_ids)).astype(np.int32)
    inv = inv_cls(UNIVERSE, len(lists), offsets, doc_ids, tfs)
    entries = []
    for lo, hi in RANGES:
        if hi == lo:
            entries.append(((lo, hi), None, None))
            continue
        sl = slicer(inv, lo, hi)
        st = hybrid.from_index(sl)
        st.attach_payloads(rng.integers(0, 256, sl.n_postings), bits=8, scale=0.0125)
        entries.append(((lo, hi), sl, st))
    return inv, entries


def _same_store(got_inv, got, want_inv, want):
    assert (got_inv.n_docs, got_inv.n_terms) == (want_inv.n_docs, want_inv.n_terms)
    assert np.array_equal(np.asarray(got_inv.doc_ids), want_inv.doc_ids)
    assert np.array_equal(np.asarray(got_inv.tfs), want_inv.tfs)
    assert np.array_equal(np.asarray(got.tags), want.tags)
    assert np.array_equal(np.asarray(got.bits), want.bits)
    assert got.size_bits() == want.size_bits()
    assert got.payload_size_bits() == want.payload_size_bits()
    assert got.codec_histogram() == want.codec_histogram()
    for t in range(want.n_terms):
        assert np.array_equal(np.asarray(got.streams[t]), want.streams[t])
        assert np.array_equal(got.postings(t), want.postings(t))
        assert np.array_equal(got.payloads(t), want.payloads(t))
        if want.lens[t]:
            assert got.term_ub(t) == want.term_ub(t)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")],
                         ids=["ref-to-port", "port-to-ref"])
def test_sharded_store_loads_in_the_other_package(tmp_path, writer, reader):
    _, entries = _sharded(writer)
    assert len({c for _, _, st in entries if st for c in st.codec_histogram()}) >= 3
    assert any(st and {"plm", "rmi"} & set(st.codec_histogram()) for _, _, st in entries)
    PACKAGES[writer][3].save_sharded(str(tmp_path / "sh"), UNIVERSE, entries)
    n_docs, loaded = PACKAGES[reader][3].load_sharded(str(tmp_path / "sh"), verify=True)
    assert n_docs == UNIVERSE and len(loaded) == len(entries)
    for ((lo, hi), inv, st), ((wlo, whi), winv, wst) in zip(loaded, entries):
        assert (lo, hi) == (wlo, whi)
        if winv is None:
            assert inv is None and st is None
            continue
        assert type(st).__module__.startswith("repro_torch" if reader == "port" else "repro.")
        assert st.has_payloads and st.payload_bits == 8 and st.payload_scale == 0.0125
        _same_store(inv, st, winv, wst)


def test_sharded_saves_are_byte_identical(tmp_path):
    """The two packages' stores of the same collection, saved by each: every
    file equal, byte for byte (the JSON files as parsed JSON)."""
    for pkg in PACKAGES:
        _, entries = _sharded(pkg)
        PACKAGES[pkg][3].save_sharded(str(tmp_path / pkg), UNIVERSE, entries)
    _same_files(tmp_path / "port", tmp_path / "ref")


def _same_files(a, b):
    files = sorted(os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    assert any(f.endswith("streams.bin") for f in files)
    for f in files:
        x, y = (a / f).read_bytes(), (b / f).read_bytes()
        if f.endswith(".json"):
            assert json.loads(x) == json.loads(y), f
        else:
            assert x == y, f


def _v1(path):
    """Rewrite a saved single-index layout as layout v1: no ranked arrays."""
    meta_path = os.path.join(path, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["version"] = 1
    for name in ("tfs", "payload_offsets", "payloads", "ub_offsets", "seg_ubs"):
        del meta["arrays"][name]
        os.unlink(os.path.join(path, f"{name}.bin"))
    del meta["payload_bits"], meta["payload_scale"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)


@pytest.mark.parametrize("reader", ["port", "ref"])
def test_v1_layout_loads_boolean_only(tmp_path, reader):
    _, entries = _sharded("port")
    (_, inv, st) = entries[2]
    store.save_index(str(tmp_path / "v1"), inv, st)
    _v1(str(tmp_path / "v1"))
    inv2, st2 = PACKAGES[reader][3].load_index(str(tmp_path / "v1"), verify=True)
    assert inv2.tfs is None and not st2.has_payloads
    for t in range(st.n_terms):
        assert np.array_equal(st2.postings(t), st.postings(t))
    assert st2.size_bits() == st.size_bits()


def test_newer_layout_and_corrupt_array_raise(tmp_path):
    _, entries = _sharded("port")
    (_, inv, st) = entries[0]
    path = tmp_path / "idx"
    store.save_index(str(path), inv, st)
    meta = json.loads((path / "meta.json").read_text())
    newer = dict(meta, version=store.STORE_VERSION + 1)
    (path / "meta.json").write_text(json.dumps(newer))
    with pytest.raises(store.UnsupportedVersionError, match="newer"):
        store.load_index(str(path))
    assert issubclass(store.UnsupportedVersionError, ValueError)
    (path / "meta.json").write_text(json.dumps(meta))
    raw = bytearray((path / "streams.bin").read_bytes())
    raw[len(raw) // 2] ^= 0x40
    (path / "streams.bin").write_bytes(bytes(raw))
    store.load_index(str(path))  # lazy: nothing read, nothing checked
    with pytest.raises(ValueError, match="crc32"):
        store.load_index(str(path), verify=True)
    with pytest.raises(FileNotFoundError):
        store.load_index(str(tmp_path / "nope"))


@pytest.mark.parametrize("source", ["memmap", "strided"])
def test_memmapped_streams_decode_and_probe_as_built(tmp_path, source):
    """Read-only memmapped streams (a loaded store), and streams that are
    strided views, through the port's batched decodes, its guided probes
    and the device StreamArena's one staging copy: the in-memory store's
    answers, and no warning about non-writable arrays.  (The host codecs
    decode contiguous streams only, which is all a store holds: the
    strided case takes the kernel-coded lists.)"""
    _, entries = _sharded("port")
    (_, inv, st) = entries[2]
    store.save_index(str(tmp_path / "idx"), inv, st)
    _, loaded = store.load_index(str(tmp_path / "idx"), mmap=True)
    if source == "strided":
        streams = [np.repeat(loaded.streams[t], 2)[::2] for t in range(st.n_terms)]
        assert not streams[2].flags.c_contiguous
        streams = [np.lib.stride_tricks.as_strided(w, writeable=False) for w in streams]
        loaded = HybridPostings(universe=st.universe, lens=st.lens, tags=st.tags,
                                bits=st.bits, streams=streams)
    terms = [t for t in range(st.n_terms) if st.lens[t]
             and (source == "memmap" or search.decode_kernel(st, t) is not None)]
    assert isinstance(loaded.streams, store.StreamArena) == (source == "memmap")
    assert not loaded.streams[terms[0]].flags.writeable
    learned = [t for t in terms if search.decode_kernel(st, t) == "plm"]
    assert learned and any(search.decode_kernel(st, t) == "pfor" for t in terms)
    rng = np.random.default_rng(5)
    cands = np.sort(rng.choice(inv.n_docs, 500, replace=False)).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = search.decode_terms(loaded, terms, torch.device("cpu"))
        for t, ids in zip(terms, got):
            assert np.array_equal(ids, st.postings(t))
        a, b = (search.build_arena(s, torch.device("cpu")) for s in (loaded, st))
        assert a.row == b.row and np.array_equal(a.first_seg, b.first_seg)
        for f in ("terms", "segs", "words"):
            assert torch.equal(getattr(a, f), getattr(b, f))
        items = [(t, cands, None) for t in learned]
        for (f1, r1), (f2, r2) in zip(search.GuidedPostings(loaded, device="cpu").probe_many(items),
                                      search.GuidedPostings(st, device="cpu").probe_many(items)):
            assert np.array_equal(f1, f2) and np.array_equal(r1, r2)


# ------------------------------------------------------------ engines
@pytest.fixture(scope="module")
def system():
    corpus = synthesize_corpus(CorpusConfig(n_docs=400, n_terms=1600, avg_doc_len=50, seed=31))
    inv = build_inverted_index(corpus)
    rng = np.random.default_rng(9)
    params_np = {
        "term_embed": {"table": (rng.standard_normal((1600, 16)) * 0.3).astype(np.float32)},
        "doc_embed": {"table": (rng.standard_normal((400, 16)) * 0.3).astype(np.float32)},
        "bias": np.float32(0.0),
    }
    lb = fit_thresholds(params_from_jax(params_np, device="cpu"), inv)
    ref_params = {"term_embed": {"table": jnp.asarray(params_np["term_embed"]["table"])},
                  "doc_embed": {"table": jnp.asarray(params_np["doc_embed"]["table"])},
                  "bias": jnp.asarray(params_np["bias"])}
    ref_lb = RefLearnedBloom(params=ref_params, tau=lb.tau.numpy(),
                             backup_keys=np.zeros(0, np.int64), n_docs=inv.n_docs)
    li_cfg = LearnedIndexConfig(embed_dim=16, truncation_k=16, block_size=64)
    ref_li = RefLIConfig(embed_dim=16, truncation_k=16, block_size=64)
    q = sample_queries(corpus, 24, seed=8)
    return corpus, inv, lb, li_cfg, ref_lb, ref_li, q


def test_engine_saves_are_byte_identical(system, tmp_path):
    """``save`` of the same engine in both packages (tier-2 and payloads
    forced by the save): the same files, byte for byte."""
    _, inv, lb, li_cfg, ref_lb, ref_li, _ = system
    BooleanEngine(lb, inv, li_cfg, ServeConfig(n_shards=3, device="cpu")).save(
        str(tmp_path / "port"))
    RefEngine(ref_lb, inv, ref_li, RefServeConfig(n_shards=3)).save(str(tmp_path / "ref"))
    _same_files(tmp_path / "port", tmp_path / "ref")
    meta = json.loads((tmp_path / "port" / "shard-0000" / "meta.json").read_text())
    assert meta["version"] == 2 and meta["payload_bits"] == 8


@pytest.mark.parametrize("algorithm", ["block", "two_tier"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_from_store_engines_agree(system, tmp_path, writer, algorithm):
    """Both packages' ``from_store`` engines on one directory: the same
    Boolean results (exact for block), the same ranked top-k, equal to
    brute force, with the store's payload scale and width (no quantizer is
    fitted); the port's engine serves the reloaded memmapped streams."""
    corpus, inv, lb, li_cfg, ref_lb, ref_li, q = system
    path = str(tmp_path / "idx")
    if writer == "port":
        BooleanEngine(lb, inv, li_cfg, ServeConfig(n_shards=2, device="cpu")).save(path)
    else:
        RefEngine(ref_lb, inv, ref_li, RefServeConfig(n_shards=2)).save(path)
    cfg = ServeConfig(algorithm=algorithm, n_shards=2, device="cpu",
                      ranked=dict(score_kernel=True))
    eng = BooleanEngine.from_store(lb, li_cfg, cfg, path)
    ref = RefEngine.from_store(ref_lb, ref_li, RefServeConfig(algorithm=algorithm, n_shards=2),
                               path)
    assert eng.inv is None and len(eng.shards) == 2
    got, want = eng.query_batch(q), ref.query_batch(q)
    for g, w, e in zip(got, want, brute_force_answers(corpus, q)):
        assert np.array_equal(g, w)
        assert np.array_equal(g, e) if algorithm == "block" else np.isin(g, e).all()
    assert eng.memory_report() == ref.memory_report()
    rq, _ = zipf_disjunctions(inv.dfs, 16, seed=7)
    top, ref_top = eng.query_topk(rq, 10), ref.query_topk(rq, 10)
    assert eng.impact_model is None
    oracle = brute_force_topk(inv, ImpactModel.build(inv), rq, 10)
    ref_oracle = ref_brute_force_topk(inv, RefImpactModel.build(inv), rq, 10)
    for g, w, o, ro in zip(top, ref_top, oracle, ref_oracle):
        assert np.array_equal(g.ids, w.ids) and np.array_equal(g.scores, w.scores)
        assert np.array_equal(g.ids, o.ids) and np.array_equal(g.scores, o.scores)
        assert np.array_equal(o.ids, ro.ids)
    assert eng.shards[0].tier2.payload_scale == ref.shards[0].tier2.payload_scale


def test_launcher_serves_from_the_store_on_cpu(tmp_path, capsys):
    serve_main(["--device", "cpu", "--docs", "300", "--terms", "1200", "--train-steps", "5",
                "--queries", "8", "--shards", "2", "--index-dir", str(tmp_path / "idx")])
    out = capsys.readouterr().out
    assert "serving from the store" in out and "exact=8/8" in out
    assert "exact-vs-BM25-brute-force=True" in out
    assert (tmp_path / "idx" / "shards.json").exists()
