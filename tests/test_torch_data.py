"""The port's learned-index training data pipeline (``repro_torch.data``),
mirroring ``tests/test_substrate.py``'s pipeline tests, and held to the
reference's: the same corpus, the same doc index and byte-equal batches."""
import numpy as np
import pytest

from repro.data.pipeline import DataPipeline as RefPipeline
from repro.data.pipeline import DocIndex as RefDocIndex
from repro.data.pipeline import PipelineConfig as RefConfig
from repro.data.pipeline import synthetic_corpus as ref_corpus
from repro_torch.data.pipeline import (DataPipeline, DocIndex,
                                       PipelineConfig, synthetic_corpus)


def test_doc_index_matches_searchsorted():
    corpus = synthetic_corpus(n_tokens=300_000, seed=3)
    di = DocIndex(corpus.boundaries, error=32)
    pos = np.random.default_rng(0).integers(0, corpus.n_tokens, size=5000)
    docs, offs = di.doc_of(pos)
    want = np.searchsorted(corpus.boundaries, pos, side="right") - 1
    np.testing.assert_array_equal(docs, want)
    np.testing.assert_array_equal(offs, pos - corpus.boundaries[want])
    assert di.index_size_bytes() < corpus.n_docs * 8


def test_pipeline_deterministic_and_resumable():
    corpus = synthetic_corpus(n_tokens=500_000, seed=1)

    def mk():
        return DataPipeline(corpus, PipelineConfig(seq_len=64, batch_size=4,
                                                   seed=7))
    p1, p2 = mk(), mk()
    for s in (0, 5, 11):
        np.testing.assert_array_equal(p1.batch_at(s)["tokens"],
                                      p2.batch_at(s)["tokens"])
    # different steps give different batches
    assert not np.array_equal(p1.batch_at(0)["tokens"],
                              p1.batch_at(1)["tokens"])


def test_pipeline_host_sharding_disjoint():
    corpus = synthetic_corpus(n_tokens=500_000, seed=1)
    a = DataPipeline(corpus, PipelineConfig(seq_len=64, batch_size=4,
                                            n_hosts=2, host_id=0, seed=7))
    b = DataPipeline(corpus, PipelineConfig(seq_len=64, batch_size=4,
                                            n_hosts=2, host_id=1, seed=7))
    assert set(a._sample_ids(3)).isdisjoint(set(b._sample_ids(3)))


def test_pipeline_prefetch_thread():
    corpus = synthetic_corpus(n_tokens=300_000, seed=2)
    p = DataPipeline(corpus, PipelineConfig(seq_len=64, batch_size=2))
    p.start(from_step=4)
    try:
        s, batch = next(iter(p))
        assert s == 4
        np.testing.assert_array_equal(batch["tokens"],
                                      p.batch_at(4)["tokens"])
    finally:
        p.stop()
    assert not p._thread.is_alive()


@pytest.mark.parametrize("seed,seq,batch", [(0, 256, 8), (7, 64, 4)])
def test_batches_equal_the_reference_byte_for_byte(seed, seq, batch):
    """The trainer's corpus (2M tokens, the reduced vocab), the doc index
    at the cost model's error, and batch_at for a few steps: every array
    equal to the reference's, tokens byte for byte."""
    corpus = synthetic_corpus(n_tokens=2_000_000, vocab=512, seed=seed)
    ref = ref_corpus(n_tokens=2_000_000, vocab=512, seed=seed)
    assert corpus.tokens.tobytes() == ref.tokens.tobytes()
    np.testing.assert_array_equal(corpus.boundaries, ref.boundaries)
    pipe = DataPipeline(corpus, PipelineConfig(seq_len=seq,
                                               batch_size=batch, seed=seed))
    want = RefPipeline(ref, RefConfig(seq_len=seq, batch_size=batch,
                                      seed=seed))
    assert pipe.doc_index.error == want.doc_index.error
    assert pipe.doc_index.index_size_bytes() == \
        want.doc_index.index_size_bytes()
    assert pipe.state_dict() == want.state_dict()
    for step in (0, 1, 12, 999):
        got, exp = pipe.batch_at(step), want.batch_at(step)
        assert got["tokens"].dtype == exp["tokens"].dtype == np.int32
        assert got["tokens"].tobytes() == exp["tokens"].tobytes()
        np.testing.assert_array_equal(got["docs"], exp["docs"])
        np.testing.assert_array_equal(got["offsets"], exp["offsets"])


def test_doc_index_equals_the_reference():
    corpus = synthetic_corpus(n_tokens=300_000, seed=3)
    got = DocIndex(corpus.boundaries, error=32)
    want = RefDocIndex(corpus.boundaries, error=32)
    pos = np.random.default_rng(5).integers(0, corpus.n_tokens, size=2000)
    for g, w in zip(got.doc_of(pos), want.doc_of(pos)):
        np.testing.assert_array_equal(g, w)
