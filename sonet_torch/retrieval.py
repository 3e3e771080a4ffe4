"""SHREC16 shape retrieval (port of the JAX package's ``retrieval.py``;
the reference's shrec16/test.py:24-99).

The classifier's 55-d score vector is the retrieval descriptor
(test.py:54).  For each query, the shapes with the same *predicted* label
are ranked by L2 distance between score vectors, and the first 1000
``id distance`` lines are written to one file a query (test.py:69-99).

The ranking is one masked (T, T) distance and one row sort on the scores'
device, in place of the reference's per-query Python loop.  The metrics
and the rank files are numpy and stdlib.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .ops.pairwise import pairwise_sqdist
from .train.graphs import StepGraph


def extract_scores(eval_step, state, loader, device_batch_fn,
                   scan_chunk: int = 1, mesh=None):
    """Forward every shape of ``loader`` -> (scores (T, C), labels (T,),
    ids (T,)), numpy, the padding of each batch (its ``valid``) dropped.

    ``eval_step(state, batch)`` is the port's (``train.make_steps``), which
    returns the ``score``; ``device_batch_fn`` makes a host batch tensors
    for it (pinned or on the model's device for a card).  On a card the
    eval step is a captured graph (``train.graphs.StepGraph``), replayed
    once a batch, as the JAX package's is a jitted program; on the CPU it
    runs eagerly.  Scores are fetched once every ``scan_chunk`` batches
    (the JAX package runs that many batches as one ``lax.scan`` program
    and fetches once); the result does not depend on it.  Under a mesh
    (``eval_step`` made with it) each rank scores its block of every batch
    and the scores are gathered over ``data``: every rank gets them all."""
    from .parallel import shard_batch
    from .parallel.distributed import all_gather
    device = next(state.model.parameters()).device
    graph = StepGraph(lambda **batch: eval_step(state, batch)["score"],
                      device, mesh=mesh)
    scores, labels, ids, pending = [], [], [], []

    def fetch():
        if pending:
            got = all_gather(torch.stack([p for p, _ in pending]),
                             ("data",), mesh, lead=1)
            got = got.float().cpu().numpy()
            scores.extend(g[:valid] for g, (_, valid) in zip(got, pending))
            pending.clear()

    for batch in loader:
        valid = int(batch.pop("valid", len(batch["label"])))
        item_ids = batch.pop("id", None)
        labels.append(np.asarray(batch["label"])[:valid])
        # the graph's output is overwritten by the next replay
        pending.append((graph(**device_batch_fn(shard_batch(batch, mesh)))
                        .clone(), valid))
        if len(pending) >= max(scan_chunk, 1):
            fetch()
        if item_ids is not None:
            ids.append(np.asarray(item_ids)[:valid])
    fetch()
    scores = np.concatenate(scores, 0)
    labels = np.concatenate(labels, 0)
    ids = (np.concatenate(ids, 0) if ids
           else np.arange(len(scores), dtype=np.int64))
    return scores, labels, ids


def rank_all(scores, top: int = 1000):
    """For every query i, the candidates with its predicted label sorted by
    L2 distance over the score vectors (ties to the lower index, as a
    stable ``jnp.argsort`` breaks them).  ``scores`` is (T, C), a tensor
    (ranked on its device) or an array (ranked on the CPU).  Returns per
    query (candidate indices, distances), numpy, at most ``top`` each.

    The distances come from |a|^2 + |b|^2 - 2 a.b in float32, as in the
    JAX package, so a query's distance to itself is 0 only up to the
    rounding of |a|^2, a few times sqrt(eps) |a|: 0.0055 for 55-d scores
    drawn from a unit normal (norm about 7.4)."""
    s = torch.as_tensor(scores)
    predicted = s.argmax(-1)                              # (T,)
    d = torch.sqrt(pairwise_sqdist(s, s))                 # (T, T), >= 0
    same = predicted[:, None] == predicted[None, :]
    masked = torch.where(same, d, torch.full_like(d, float("inf")))
    dist_sorted, order = torch.sort(masked, dim=1, stable=True)
    counts = same.sum(dim=1).cpu().numpy()                # candidates a query
    order, dist_sorted = order.cpu().numpy(), dist_sorted.cpu().numpy()
    results = []
    for i in range(len(counts)):
        n = min(int(counts[i]), top)
        results.append((order[i, :n], dist_sorted[i, :n]))
    return results


def retrieval_metrics(results, labels: np.ndarray, ks=(1, 5, 10)):
    """Ranking quality over a labelled split: mAP and precision@k.

    The reference ships no retrieval metric (shrec16/test.py writes rank
    files only).  Relevance is the same ground-truth label; the query
    itself is left out.  AP divides by the number of relevant shapes in
    the whole split, so a candidate list that misses relevant shapes (a
    query classified into the wrong class) scores below 1, down to 0.
    """
    labels = np.asarray(labels)
    aps = []
    p_at = {k: [] for k in ks}
    for q, (cand, _dist) in enumerate(results):
        ranked = np.asarray([c for c in cand if c != q], dtype=np.int64)
        n_relevant = int((labels == labels[q]).sum()) - 1
        if n_relevant <= 0:
            continue  # singleton class: AP undefined
        rel = (labels[ranked] == labels[q]).astype(np.float64)
        if len(rel):
            precision = np.cumsum(rel) / np.arange(1, len(rel) + 1)
            aps.append(float((precision * rel).sum() / n_relevant))
        else:
            aps.append(0.0)
        for k in ks:
            p_at[k].append(float(rel[:k].sum()) / k)
    out = {"mAP": float(np.mean(aps)) if aps else 0.0}
    for k in ks:
        out[f"P@{k}"] = float(np.mean(p_at[k])) if p_at[k] else 0.0
    return out


def write_rank_files(results, ids: np.ndarray, out_dir: str) -> None:
    """One file per query named %06d with '%06d %f' lines (test.py:93-99)."""
    os.makedirs(out_dir, exist_ok=True)
    for i, (cand_idx, dist) in enumerate(results):
        name = "%06d" % int(ids[i])
        rows = np.stack([ids[cand_idx].astype(np.float64), dist], 1)
        np.savetxt(os.path.join(out_dir, name), rows, fmt="%06d %f",
                   delimiter=" ")


def write_retrieval_gallery(results, ids: np.ndarray, dataset,
                            out_dir: str, num_queries: int = 8,
                            top: int = 3) -> str:
    """Render query + top-k retrieved clouds to an HTML gallery, the role
    of the reference's Matlab retrieval pictures
    (data/sampler_matlab/visualization.m); needs matplotlib.

    ``dataset[i]`` must return an item dict with a ``pc`` array in the
    order ``extract_scores`` consumed it.
    """
    from .utils.visualize import HTMLGallery, save_point_cloud_png

    gallery = HTMLGallery(out_dir, title="retrieval results")
    for q in range(min(num_queries, len(results))):
        cand_idx, dist = results[q]
        row = [save_point_cloud_png(
            os.path.join(out_dir, f"q{q}_query.png"),
            np.asarray(dataset[q]["pc"]), title=f"query {int(ids[q])}")]
        caps = ["query"]
        for rank, (ci, d) in enumerate(zip(cand_idx[1:top + 1],
                                           dist[1:top + 1])):
            row.append(save_point_cloud_png(
                os.path.join(out_dir, f"q{q}_r{rank}.png"),
                np.asarray(dataset[int(ci)]["pc"]),
                title=f"#{rank + 1} d={float(d):.3f}"))
            caps.append(f"#{rank + 1} id {int(ids[int(ci)])}")
        gallery.add_row(f"query {int(ids[q])}", row, caps)
    return gallery.save()
