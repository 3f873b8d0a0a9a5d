"""The depth network's device time per frame in the traced chunk: the
records between each depth span's own markers (ms)."""

SPANS = ("frontend", "depth")  # the frontend span frames the trace


def depth_records(run):
    """[(kept, starts, ends)] of the traced chunk's depth spans, each with
    the records between its own markers; None when the trace has none or
    its marked spans do not pair with the markers."""
    p = run.profile
    marked = [s for s in run.spans if s.profiled and s.kept is not None]
    if not p or len(p["marked"]) != len(marked):
        return None
    out = [(s.kept_on_host(), p["start"][i:j], p["end"][i:j], p["names"][i:j])
           for s, (i, j) in zip(marked, p["marked"]) if s.name == "depth"]
    return out or None


def read(run):
    recs = depth_records(run)
    if recs is None:
        return None
    frames = sum(k["frames"] for k, *_ in recs)
    device_ns = sum(float((e - s).sum()) for _, s, e, _ in recs)
    return device_ns / 1e6 / frames if frames else None
