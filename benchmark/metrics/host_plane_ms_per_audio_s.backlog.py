"""The server handlers' host work (read body, decode WAV, slice, reply) in
milliseconds a second of audio, each part over its spans inside the traced
stretch (the program's spans)."""
from benchmark.harness.attribution import host_plane_ms_per_audio_s


def read(obs):
    return host_plane_ms_per_audio_s(obs)
