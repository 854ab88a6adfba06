"""Closed-loop HTTP clients in a process of their own.

    python3 -m radarbench.gen.clients URL BODIES_DIR CLIENTS \
        (--seconds S | --requests N)

from the checkout's root. Reads the request bodies ``BODIES_DIR/<b>.json``
(b = 0, 1, ...), prints "ready", and waits for a line on stdin; then
``CLIENTS`` threads each POST their next body to URL as soon as the last
answer is in, client c's k-th request sending body (c + k) mod the number
of bodies, until S seconds have passed or each has sent N requests. The
last line on stdout is one JSON object: "seconds" (the window asked for,
or the time the requests took), "answers" ([seconds since the start when
the answer came, body, HTTP status, the parsed answer] per request, in
the order they came) and "cpu_s" (this process's CPU seconds in the
run).

The clients live in their own process so that their Python work does not
take the interpreter lock from the service's threads, as remote clients
would not. Nothing here imports torch or the program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

REQUEST_TIMEOUT_S = 300.0


def post(opener, url: str, body: bytes) -> tuple[int, dict]:
    """POST ``body`` to ``url``; (HTTP status, parsed answer), and status 0
    where no answer came (a refused or broken connection, a timeout)."""
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with opener.open(req, timeout=REQUEST_TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, {"status": "error",
                            "message": e.read()[:200].decode(errors="replace")}
    except (OSError, ValueError) as e:  # URLError is an OSError; a torn body a ValueError
        return 0, {"status": "error", "message": repr(e)[:200]}


def run(url: str, bodies: list[bytes], clients: int, seconds: float | None,
        requests: int | None) -> dict:
    """The closed loop; its answers as the module's result object."""
    # No proxy, whatever the environment says: the service is local.
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    answers: list = []
    lock = threading.Lock()
    start = threading.Barrier(clients + 1)
    t0 = 0.0

    def client(c: int) -> None:
        start.wait()
        k = 0
        while (requests is None or k < requests) and (
                seconds is None or time.perf_counter() - t0 < seconds):
            body = (c + k) % len(bodies)
            status, answer = post(opener, url, bodies[body])
            with lock:
                answers.append([time.perf_counter() - t0, body, status, answer])
            k += 1

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}")
               for c in range(clients)]
    for th in threads:
        th.start()
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    start.wait()
    for th in threads:
        th.join()
    took = time.perf_counter() - t0
    return {"seconds": seconds if seconds is not None else took, "answers": answers,
            "cpu_s": time.process_time() - cpu0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("url")
    ap.add_argument("bodies_dir")
    ap.add_argument("clients", type=int)
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--seconds", type=float)
    group.add_argument("--requests", type=int)
    args = ap.parse_args(argv)
    bodies = []
    while os.path.exists(path := os.path.join(args.bodies_dir, f"{len(bodies)}.json")):
        with open(path, "rb") as f:
            bodies.append(f.read())
    if not bodies:
        raise SystemExit(f"no bodies in {args.bodies_dir}")
    print("ready", flush=True)
    sys.stdin.readline()
    print(json.dumps(run(args.url, bodies, args.clients, args.seconds, args.requests)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
