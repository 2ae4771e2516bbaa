"""The load generator: a process of its own that sends songs to the server.

It imports neither torch nor the program. ``main`` runs in a spawned child:
it receives the port, the songs' WAV bytes and the plan, reports ready,
waits for the window's start, sends, and returns one record per request
(song, due, sent, done, HTTP status) and, per song, its first reply's body.
The loop is closed: ``clients`` threads, each sending its next song as soon
as its last reply came, until the window closes; the songs go in the
plan's order.
"""
from __future__ import annotations

import http.client
import threading
import time

PATH = "/transcribe?format=json"


def _send(port: int, body: bytes, timeout: float):
    """(status, reply body) of one POST; status 0 if the connection failed."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", PATH, body=body,
                     headers={"Content-Type": "audio/wav", "Content-Length": str(len(body))})
        resp = conn.getresponse()
        return resp.status, resp.read()
    except (OSError, http.client.HTTPException):
        return 0, b""
    finally:
        conn.close()


class _Log:
    def __init__(self):
        self.lock = threading.Lock()
        self.records = []
        self.replies = {}

    def add(self, song, due, sent, done, status, body):
        with self.lock:
            self.records.append((song, due, sent, done, status))
            if status == 200 and song not in self.replies:
                self.replies[song] = body


def run_closed(port, songs, plan, t0, log):
    t_end = t0 + plan["seconds"]
    order = plan["order"]
    nxt = [0]
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            now = time.monotonic()
            if now >= t_end:
                return
            song = order[i % len(order)]
            status, body = _send(port, songs[song], plan["timeout_s"])
            log.add(song, now, now, time.monotonic(), status, body)

    while time.monotonic() < t0:
        time.sleep(0.0005)
    threads = [threading.Thread(target=client) for _ in range(plan["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def main(conn, port: int, songs: list, plan: dict) -> None:
    """The child's entry: ready -> (t0) -> run -> (records, replies)."""
    conn.send("ready")
    t0 = conn.recv()
    log = _Log()
    run_closed(port, songs, plan, t0, log)
    conn.send((log.records, log.replies))
    conn.close()
