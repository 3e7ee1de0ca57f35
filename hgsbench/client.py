"""The viewer's client: one closed loop over the SIBR wire protocol.

    python -m hgsbench.client <port> <requests.jsonl> <seconds> <out.json> \
        <sample indices, comma-separated> <frame dir> <warm-up frames>

Sends the first <warm-up frames> requests untimed (the server counts
them as set-up); then sends the requests in order from the first
(cycling) to 127.0.0.1:<port>, one at a time, and times each from the
send to the last byte of the verify string, for `seconds`. Each frame is received into one preallocated buffer, the
verify string into another. The
frames of the sampled indices are written to <frame dir> the first time
they come. Writes the times and counts to <out.json>. Imports neither
torch nor the program.
"""
from __future__ import annotations

import json
import os
import socket
import sys
import time

from hgsbench.wire import frame_message


def recv_into(conn: socket.socket, view: memoryview) -> None:
    got = 0
    while got < len(view):
        n = conn.recv_into(view[got:])
        if n == 0:
            raise ConnectionError("server closed the connection")
        got += n


def exchange(conn, msg: bytes, frame: memoryview, tail: bytearray) -> None:
    """One request: send it, receive the frame and the verify string."""
    conn.sendall(msg)
    recv_into(conn, frame)
    recv_into(conn, memoryview(tail)[:4])
    n = int.from_bytes(tail[:4], "little")
    recv_into(conn, memoryview(tail)[:n])


def main(argv) -> int:
    port, path, seconds, out = int(argv[0]), argv[1], float(argv[2]), argv[3]
    sample = {int(i) for i in argv[4].split(",") if i}
    frame_dir, warmup = argv[5], int(argv[6])
    with open(path) as f:
        requests = [json.loads(line) for line in f]
    msgs = [frame_message(r) for r in requests]
    sizes = [r["resolution_x"] * r["resolution_y"] * 3 for r in requests]
    buf = memoryview(bytearray(max(sizes)))
    tail = bytearray(4096)
    times, failed, sent, saved = [], 0, 0, set()
    conn = socket.create_connection(("127.0.0.1", port))
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        for i in range(warmup):
            j = i % len(msgs)
            exchange(conn, msgs[j], buf[:sizes[j]], tail)
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            i = sent % len(msgs)
            sent += 1
            t0 = time.perf_counter()
            try:
                exchange(conn, msgs[i], buf[:sizes[i]], tail)
            except (ConnectionError, OSError):
                failed += 1
                break
            times.append((time.perf_counter() - t0) * 1e3)
            if i in sample and i not in saved:
                with open(os.path.join(frame_dir, f"{i}.u8"), "wb") as f:
                    f.write(buf[:sizes[i]])
                saved.add(i)
    finally:
        conn.close()
    with open(out, "w") as f:
        json.dump({"times_ms": times, "sent": sent, "failed": failed,
                   "saved": sorted(saved)}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
