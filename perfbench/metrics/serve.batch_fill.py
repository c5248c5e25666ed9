"""Frames requested over the compiled batch's slots replayed, in percent, over the served program's replays recorded in the traced window (span serve.replay): each replay serves the requests named by the rid of the span around it (serve.device: one id, or a tuple of the ids of the requests one replay serves); the numerator is the n of those requests' serve.request spans, the denominator the batch times the replays."""


def _rids(rec, by_id):
    """The request ids of the nearest enclosing span that has a rid."""
    p = by_id.get(rec.parent)
    while p is not None and "rid" not in p.attrs:
        p = by_id.get(p.parent)
    if p is None:
        return ()
    rid = p.attrs["rid"]
    return rid if isinstance(rid, tuple) else (rid,)


def read(r):
    if r.get("kind") != "serve":
        return None
    try:
        from neural_human_video_rendering_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    recs = spans.records()
    by_id = {s.id: s for s in recs}
    reqs = {s.attrs["rid"]: s.attrs for s in recs if s.name == "serve.request"}
    served, replays = set(), 0
    for s in recs:
        if s.name == "serve.replay":
            rids = [i for i in _rids(s, by_id) if i in reqs]
            if rids:
                replays += 1
                served.update(rids)
    if not replays:
        return None
    batch = reqs[next(iter(served))]["batch"]
    return 100.0 * sum(reqs[i]["n"] for i in served) / (batch * replays)
