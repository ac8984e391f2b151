"""Open-loop HTTP load generator: a process of its own that imports
neither torch nor the program, so its Python never holds the server's
interpreter lock.

Reads from standard input one JSON object per line: requests
``{"due": <s after start>, "body": "<JSON body>"}``, then
``{"start": <time.monotonic() of the window's start>, "port": <port>,
"path": "/generate", "drain_s": <s>, "seconds": <window s>}``.  Each
request is sent from a thread of its own at ``start + due``, whether or
not earlier ones have been answered.  Writes one JSON line per request
to standard output, in the order given: ``due``, ``sent`` and ``done``
(``time.monotonic()``; ``done`` is null for a request with no reply
before ``drain_s`` after the window's end), ``status`` and the reply's
``image`` or ``error``.

Run by the serving driver; ``python3 loadgen.py < schedule.jsonl`` runs
it alone against a server on localhost.
"""

import http.client
import json
import sys
import threading
import time


def _send(port: int, path: str, body: bytes, rec: dict) -> None:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        rec["sent"] = time.monotonic()
        conn.request("POST", path, body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        rec["status"] = resp.status
        try:
            reply = json.loads(data)
        except ValueError:
            reply = {"error": data[:200].decode("latin-1")}
        if resp.status == 200 and "image" in reply:
            rec["image"] = reply["image"]
        else:
            rec["error"] = str(reply.get("error", ""))[:200]
        rec["done"] = time.monotonic()
    except OSError as e:
        rec["error"] = f"{type(e).__name__}: {e}"[:200]
    finally:
        conn.close()


def main() -> None:
    requests, ctl = [], None
    for line in sys.stdin:
        obj = json.loads(line)
        if "start" in obj:
            ctl = obj
            break
        requests.append(obj)
    if ctl is None:
        raise SystemExit("loadgen: no start line")
    start, port = ctl["start"], ctl["port"]
    records, threads = [], []
    for req in requests:
        rec = {"due": start + req["due"], "sent": None, "done": None,
               "status": None, "image": None, "error": None}
        records.append(rec)
        delay = rec["due"] - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        t = threading.Thread(target=_send, daemon=True,
                             args=(port, ctl.get("path", "/generate"),
                                   req["body"].encode(), rec))
        t.start()
        threads.append(t)
    deadline = start + ctl["seconds"] + ctl["drain_s"]
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    out = sys.stdout
    for rec in records:
        # a reply after the drain's end is a reply that never came
        if rec["done"] is not None and rec["done"] > deadline:
            rec["done"], rec["image"] = None, None
        out.write(json.dumps(rec) + "\n")
    out.flush()


if __name__ == "__main__":
    main()
