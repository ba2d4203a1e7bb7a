"""Port of the reference's examples/ai.py: k-NN sentiment classification
driven through DuckDB SQL, with faiss_* registered as UDFs on the
connection (sql/duckdb_bridge.py) instead of a loadable extension.

The reference embeds tweets with sentence-transformers and majority-votes
the 5 nearest training tweets' sentiments (the reference's
examples/ai.py).  This port keeps the exact SQL flow — create → add (id,
emb) → UNNEST(faiss_search(...)).label → join → majority vote — and swaps
the data source: embeddings are synthetic clustered vectors whose cluster
decides the "sentiment" (so the classifier has signal to find, like real
sbert embeddings would).

    python -m duckdb_faiss_ext_tpu_torch.examples.duckdb_knn_classify [--cpu]

Needs the optional duckdb package; without it the script explains and
exits 0 (the same flow minus DuckDB: examples/knn_classify.py).
"""

import sys

import numpy as np

from .. import api
from ..sql import register_duckdb
from ._common import parser, select_device

D, N_TEST, K = 64, 200, 5
SENTIMENTS = ["negative", "neutral", "positive"]


def main(argv=None) -> int:
    args = parser(__doc__, 2000).parse_args(argv)
    try:
        import duckdb
    except ImportError:
        print("duckdb is not installed in this environment; the DuckDB-"
              "driven flow needs it (pip install duckdb).  The same "
              "classification flow without DuckDB: "
              "python -m duckdb_faiss_ext_tpu_torch.examples.knn_classify")
        return 0
    select_device(args)
    rng = np.random.default_rng(42)
    centers = rng.standard_normal((len(SENTIMENTS), D)).astype(np.float32) * 3

    def embed(labels):
        return (centers[labels]
                + rng.standard_normal((len(labels), D)).astype(np.float32))

    train_y = rng.integers(0, len(SENTIMENTS), args.n)
    test_y = rng.integers(0, len(SENTIMENTS), N_TEST)
    train_emb, test_emb = embed(train_y), embed(test_y)

    con = duckdb.connect()
    register_duckdb(con)       # the LOAD '...faiss.duckdb_extension' analogue
    con.execute("CREATE TABLE training(id BIGINT, sentiment VARCHAR, "
                "emb FLOAT[])")
    con.executemany("INSERT INTO training VALUES (?, ?, ?)",
                    [(i, SENTIMENTS[train_y[i]], train_emb[i].tolist())
                     for i in range(args.n)])
    con.execute("CREATE TABLE testing(id BIGINT, sentiment VARCHAR, "
                "emb FLOAT[])")
    con.executemany("INSERT INTO testing VALUES (?, ?, ?)",
                    [(i, SENTIMENTS[test_y[i]], test_emb[i].tolist())
                     for i in range(N_TEST)])

    # ai.py: CALL FAISS_CREATE('flat', d, 'IDMap,Flat'); CALL FAISS_ADD(...)
    con.execute(f"SELECT faiss_create('flat', {D}, 'IDMap,Flat')")
    con.execute("SELECT faiss_add_with_ids(id, emb, 'flat') FROM training")

    # ai.py: UNNEST(FAISS_SEARCH('flat', 5, emb)).label other_tweet_id
    accuracy = con.execute(f"""
        WITH hits AS (
            SELECT t.id, t.sentiment,
                   UNNEST(faiss_search('flat', {K}, t.emb)).label AS other_id
            FROM testing t),
        votes AS (
            SELECT hits.id, hits.sentiment, tr.sentiment AS other_sentiment,
                   COUNT(*) AS c
            FROM hits JOIN training tr ON hits.other_id = tr.id
            GROUP BY 1, 2, 3),
        majority AS (
            SELECT id, sentiment,
                   FIRST(other_sentiment ORDER BY c DESC) AS predicted
            FROM votes GROUP BY 1, 2)
        SELECT AVG(CASE WHEN sentiment = predicted THEN 1.0 ELSE 0.0 END)
        FROM majority""").fetchone()[0]

    print(f"k-NN majority-vote sentiment accuracy over {N_TEST} test rows: "
          f"{accuracy:.3f}")
    api.faiss_destroy("flat")
    if accuracy <= 0.9:
        raise SystemExit("clustered embeddings should classify cleanly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
