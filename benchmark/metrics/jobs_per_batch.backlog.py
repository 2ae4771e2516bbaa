"""Requests answered per dispatched batch in the window (/stats requests, batches)."""


def read(obs):
    d = obs.get("dispatcher")
    return d["requests"] / d["batches"] if d and d["batches"] else None
