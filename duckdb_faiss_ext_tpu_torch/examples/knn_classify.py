"""k-NN majority-vote classification over an index.

The analogue of the reference's Python examples (examples/ai.py /
examples/ai3.py): embed labeled documents, add them to an index with their
class as part of the label space, then classify queries by majority vote
over the k nearest neighbours.  The reference embeds tweets with
sentence-transformers; this example uses synthetic class-clustered
embeddings so it runs without model downloads — swap ``embed()`` for a
real encoder in production.

    python -m duckdb_faiss_ext_tpu_torch.examples.knn_classify [--cpu]
"""

import sys

import numpy as np

from .. import api
from ..catalog import Catalog
from ._common import parser, select_device

NUM_CLASSES = 3
DIM = 64


def main(argv=None) -> int:
    args = parser(__doc__, 1500).parse_args(argv)
    select_device(args)
    rng = np.random.default_rng(0)
    class_centers = rng.standard_normal((NUM_CLASSES, DIM)).astype(np.float32)
    per_class = args.n // NUM_CLASSES

    def embed(class_id: int, n: int) -> np.ndarray:
        """Stand-in embedding model: points near the class centroid."""
        return (class_centers[class_id]
                + 0.7 * rng.standard_normal((n, DIM)).astype(np.float32))

    # Label encoding: label = doc_id * NUM_CLASSES + class (so the class is
    # recoverable from the search result labels alone).
    train_x, train_labels = [], []
    for c in range(NUM_CLASSES):
        train_x.append(embed(c, per_class))
        train_labels.append((np.arange(per_class) + c * per_class)
                            * NUM_CLASSES + c)
    xb = np.concatenate(train_x)
    ids = np.concatenate(train_labels)

    cat = Catalog()
    api.faiss_create("sentiment", DIM, "IDMap,Flat", metric_type="L2",
                     catalog=cat)
    api.faiss_add((ids, xb), "sentiment", catalog=cat)

    correct = total = 0
    for c in range(NUM_CLASSES):
        res = api.faiss_search("sentiment", 15, embed(c, 50), catalog=cat)
        votes = res["label"] % NUM_CLASSES
        pred = np.array([np.bincount(v[v >= 0] if (v >= 0).any() else [0],
                                     minlength=NUM_CLASSES).argmax()
                         for v in votes])
        correct += int((pred == c).sum())
        total += pred.size
    print(f"k-NN majority-vote accuracy: {correct / total:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
