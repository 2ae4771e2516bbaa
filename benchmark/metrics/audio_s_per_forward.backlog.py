"""Audio seconds answered per engine forward in the window (/stats, engine.forwards)."""


def read(obs):
    d = obs.get("dispatcher")
    return d["audio_seconds"] / obs["forwards"] if d and obs.get("forwards") else None
