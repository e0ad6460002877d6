"""sparse.routing_ms: device ms a step under the routing's spans
(`core/sparse.py`: route_build, owner_apply, route_return,
combine_grads)."""

SPANS = ("routing.route_build", "routing.owner_apply",
         "routing.route_return", "routing.combine_grads")


def read(r: dict):
    s = sum(r["span_device_s"].get(k, 0.0) for k in SPANS)
    return s / r["traced_steps"] * 1e3 if s > 0 else None
