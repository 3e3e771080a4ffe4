"""clouds_per_dispatch.serve: the clouds the engine served over the window
per dispatch to the device (the change in ``engine.stats()``'s ``items``
over the change in its ``dispatches``)."""


def read(r):
    s = r.get("engine")
    if not s or s["dispatches"] <= 0:
        return None
    return s["items"] / s["dispatches"]
