"""Paged-block migration between serving replicas (counterpart of
``nezha_tpu/serve/migrate.py``, whose wire it speaks byte for byte).

The wire carries a finished prompt's KV from the replica that prefilled
it to the one that decodes it: the int8+scales block payload
(``ops/quant.py``, about 4x fewer bytes than bf16), base64 in JSON with
its geometry. This module holds the codec, the ``/kv_export`` and
``/kv_ack`` handler bodies the HTTP front end (``cli/serve.run_http``)
mounts, and the pull clients.

The protocol is PULL-BASED and TWO-PHASE, so that a crash at any point
leaves one owner of the request, or a typed, retryable failure:

1. **park**: the source admits the request with ``prefill_only``; the
   scheduler prefills the prompt and parks the slot (blocks held) under
   a TTL instead of decoding;
2. **pull**: the destination, given ``pull_from``, POSTs ``/kv_export``
   to the source, which exports the parked prompt's full-block prefix in
   the wire format (a read-only gather; its references stay);
3. **install**: the destination allocates fresh blocks, scatters the
   payload in and indexes them in its prefix trie; the request it then
   submits binds them as a prefix hit and prefills only the tail;
4. **ACK**: only then does the destination POST ``/kv_ack``, and the
   source frees the parked slot. A lost ACK is absorbed by the park TTL.

Failure is typed: a pull or install failure raises
:class:`MigrationError`, which the front end answers as HTTP 424 with
``error_type`` its ``kind`` (``"migration_failed"``, or ``"park_lost"``
when the source no longer holds the park).

The same wire carries the PEER PULL: ``/kv_export`` in tokens mode
exports the longest cached full-block prefix of any prompt from the
source's prefix trie and host tier (read-only, no park, no ACK), and
:func:`pull_prefix_into` installs it tagged ``origin="peer"``; its
failures are ``kind="kv_pull_failed"`` and the front end degrades to a
cold prefill.

The fault points are JAX's: ``replica.kv_export`` and
``replica.kv_install`` in the scheduler's two ends (an injected error is
a typed 500 or a :class:`MigrationError`), ``replica.kv_pull`` at the
head of :func:`pull_prefix_into`. A traced pull is one ``serve.kv_install``
span, the trace id forwarded to the source on both endpoints.
"""

from __future__ import annotations

import base64
import http.client
import json
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from nezha_tpu_torch import faults, obs
from nezha_tpu_torch.serve.slots import KVBlocksExhausted

WIRE_VERSION = 1

# Wire dtypes per payload key — the int8+scales block layout.
_WIRE_DTYPES = {"k": np.int8, "v": np.int8,
                "k_scale": np.float32, "v_scale": np.float32}


class MigrationError(RuntimeError):
    """Typed migration failure (source gone, payload mismatch, pool
    exhausted). The replica front end answers it as HTTP 424 with
    ``error_type = kind``: ``"migration_failed"`` (retryable: another
    destination, or a local resume on the source) or ``"park_lost"``
    (the source answered but no longer holds the park — TTL expired,
    drained, or ACKed to a puller that then died — so every further pull
    or resume is doomed and the request restarts from prefill). Never a
    silent drop and never a crash of the decode loop."""

    def __init__(self, msg: str, kind: str = "migration_failed"):
        super().__init__(msg)
        self.kind = kind


# ------------------------------------------------------------ wire codec
def encode_wire(tokens: Sequence[int],
                layers: List[Dict[str, np.ndarray]],
                block_size: int) -> dict:
    """Block payload -> JSON-safe wire object (arrays as base64 of raw
    bytes + explicit geometry, so the installer can validate before it
    touches its pool)."""

    def b64(a: np.ndarray) -> str:
        return base64.b64encode(
            np.ascontiguousarray(a).tobytes()).decode("ascii")

    nbytes = sum(a.nbytes for layer in layers for a in layer.values())
    if layers:
        n, heads, bs, d = layers[0]["k"].shape
    else:
        n, heads, bs, d = 0, 0, block_size, 0
    return {"v": WIRE_VERSION,
            "tokens": [int(t) for t in tokens],
            "block_size": int(block_size), "nblocks": int(n),
            "heads": int(heads), "head_dim": int(d),
            "num_layers": len(layers), "nbytes": int(nbytes),
            "layers": [{k: b64(layer[k]) for k in _WIRE_DTYPES}
                       for layer in layers]}


def decode_wire(obj: dict) -> Tuple[List[int],
                                    List[Dict[str, np.ndarray]], int]:
    """Wire object -> (tokens, per-layer host arrays, payload bytes).
    Raises :class:`MigrationError` on anything malformed — a corrupt
    payload must fail typed BEFORE any pool state is touched."""
    try:
        if obj.get("v") != WIRE_VERSION:
            raise ValueError(f"wire version {obj.get('v')!r} != "
                             f"{WIRE_VERSION}")
        tokens = [int(t) for t in obj["tokens"]]
        n, heads = int(obj["nblocks"]), int(obj["heads"])
        bs, d = int(obj["block_size"]), int(obj["head_dim"])
        layers: List[Dict[str, np.ndarray]] = []
        for entry in obj["layers"]:
            layer = {}
            for key, dtype in _WIRE_DTYPES.items():
                raw = base64.b64decode(entry[key])
                shape = ((n, heads, bs, d) if dtype == np.int8
                         else (n, heads))
                arr = np.frombuffer(raw, dtype=dtype)
                if arr.size != int(np.prod(shape)):
                    raise ValueError(
                        f"payload {key!r} carries {arr.size} elements, "
                        f"geometry says {shape}")
                layer[key] = arr.reshape(shape)
            layers.append(layer)
        if len(layers) != int(obj["num_layers"]):
            raise ValueError(f"{len(layers)} layer(s) decoded, header "
                             f"says {obj['num_layers']}")
        return tokens, layers, int(obj["nbytes"])
    except MigrationError:
        raise
    except Exception as e:
        raise MigrationError(
            f"malformed migration payload: {type(e).__name__}: {e}")


# -------------------------------------------------------- handler bodies
def _handle_prefix_export(scheduler, obj) -> Tuple[int, dict]:
    """``/kv_export`` TOKENS mode (the peer pull): export the longest
    cached full-block prefix of the given tokens — a read-only cache
    probe with no park, no request and no ACK. Zero coverage is a 200
    with an empty wire (a stale hint costs the puller one wasted probe,
    never an error). A head-sharded pool exports the one-device wire
    (gather-on-export)."""
    tokens = obj.get("tokens")
    if not isinstance(tokens, list) or \
            not all(isinstance(t, int) for t in tokens):
        return 400, {"error": "tokens (list of ints) required",
                     "error_type": "bad_request"}
    try:
        wire = scheduler.export_prefix(tokens)
    except MigrationError as e:
        return 409, {"error": str(e), "error_type": e.kind}
    return 200, wire


def handle_kv_export(scheduler, obj) -> Tuple[int, dict]:
    """POST ``/kv_export`` body: the source side of the pull. Two
    modes share the endpoint (and therefore the wire format):
    ``request_id`` pulls a PARKED request's prefix (the two-phase
    migration — refs released only by ``/kv_ack``), while ``tokens``
    probes the prefix CACHE (the peer pull — read-only, nothing to
    ACK). Every failure is typed."""
    if isinstance(obj, dict) and "request_id" not in obj \
            and "tokens" in obj:
        return _handle_prefix_export(scheduler, obj)
    rid = obj.get("request_id") if isinstance(obj, dict) else None
    if not isinstance(rid, str) or not rid:
        return 400, {"error": "request_id (string) required",
                     "error_type": "bad_request"}
    try:
        wire = scheduler.export_parked(rid)
    except KeyError:
        return 404, {"error": f"request {rid!r} is not parked here",
                     "error_type": "migration_failed"}
    except faults.InjectedFault as e:
        return 500, {"error": str(e), "error_type": "injected_fault"}
    except MigrationError as e:
        return 409, {"error": str(e), "error_type": "migration_failed"}
    return 200, wire


def handle_kv_ack(scheduler, obj) -> Tuple[int, dict]:
    """POST ``/kv_ack`` body: the COMMIT of the two-phase handoff — the
    decode side holds its own copy, so the source releases the parked
    slot and its block refs. Idempotent: acking an already-released
    (or TTL-expired) park answers ``released: false`` rather than
    erroring, so a duplicate ACK can never double-free."""
    rid = obj.get("request_id") if isinstance(obj, dict) else None
    if not isinstance(rid, str) or not rid:
        return 400, {"error": "request_id (string) required",
                     "error_type": "bad_request"}
    return 200, {"id": rid, "released": scheduler.ack_parked(rid)}


def dispatch_kv_endpoint(scheduler, path: str,
                         raw_body: bytes) -> Tuple[int, dict]:
    """One shared body-parse + route for the migration endpoints
    ``/kv_export`` and ``/kv_ack`` (``cli/serve.run_http`` mounts them
    through this)."""
    try:
        obj = json.loads(raw_body)
    except ValueError as e:
        return 400, {"error": str(e)}
    handler = (handle_kv_export if path == "/kv_export"
               else handle_kv_ack)
    return handler(scheduler, obj)


# ---------------------------------------------------------- pull client
def _post_json(host: str, port: int, path: str, obj: dict,
               timeout_s: float) -> Tuple[int, dict]:
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request("POST", path, body=json.dumps(obj).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            return resp.status, json.loads(raw)
        except ValueError:
            return resp.status, {"error": "non-JSON response"}
    finally:
        conn.close()


def pull_into(scheduler, pull: dict, timeout_s: float = 120.0) -> dict:
    """The decode side's whole migration: pull the span from the source
    named by ``pull`` (``{"port": ..., "request_id": ...}``), install it
    into this replica's pool + prefix trie, then ACK the source. ->
    meta ``{"bytes", "blocks", "installed", "seconds", "acked"}`` for
    the response's ``migration`` block. Raises :class:`MigrationError`
    on any failure — by the install
    invariants nothing is leaked on either side (the source still owns
    its parked blocks until the ACK; a failed install released every
    block it allocated)."""
    if not isinstance(pull, dict):
        raise MigrationError("pull_from must be an object")
    try:
        port = int(pull["port"])
        rid = str(pull["request_id"])
    except (KeyError, TypeError, ValueError):
        raise MigrationError(
            "pull_from requires integer 'port' and string 'request_id'")
    host = str(pull.get("host", "127.0.0.1"))
    # The router's trace id: the whole hop (export, install, ACK) is one
    # serve.kv_install span, and the id goes to the source on both
    # endpoints. Untraced pulls record nothing.
    tid = pull.get("trace_id")
    kv_body = {"request_id": rid}
    if tid:
        kv_body["trace_id"] = tid
    with obs.trace_context(tid):
        with obs.traced_span("serve.kv_install", request_id=rid) as sp:
            t0 = time.monotonic()
            try:
                status, wire = _post_json(host, port, "/kv_export",
                                          kv_body, timeout_s)
            except Exception as e:
                raise MigrationError(f"kv_export pull from {host}:{port} "
                                     f"failed: {type(e).__name__}: {e}")
            if status != 200:
                raise MigrationError(
                    f"kv_export from {host}:{port} answered {status}: "
                    f"{wire.get('error') if isinstance(wire, dict) else wire}",
                    # A live source answering 404 no longer holds the
                    # park (TTL, drain, or committed elsewhere): no other
                    # pull can succeed.
                    kind="park_lost" if status == 404
                    else "migration_failed")
            tokens, layers, nbytes = decode_wire(wire)
            try:
                installed = scheduler.install_migrated(tokens, layers,
                                                       nbytes)
            except faults.InjectedFault as e:
                raise MigrationError(f"kv_install injected fault: {e}")
            except KVBlocksExhausted as e:
                raise MigrationError(
                    f"kv_install found no free blocks: {e}")
            except ValueError as e:
                raise MigrationError(
                    f"kv_install rejected the payload: {e}")
            # COMMIT: the copy is ours, release the source. Best effort:
            # a lost ACK costs the source its park TTL, and the request
            # is safe here.
            try:
                status, _ = _post_json(host, port, "/kv_ack", kv_body,
                                       timeout_s)
                acked = status == 200
            except Exception:
                acked = False
            nblocks = int(layers[0]["k"].shape[0]) if layers else 0
            sp.set(bytes=nbytes, blocks=nblocks, acked=acked)
            return {"bytes": nbytes, "blocks": nblocks,
                    "installed": installed,
                    "seconds": time.monotonic() - t0, "acked": acked}


def pull_prefix_into(scheduler, pull: dict,
                     timeout_s: float = 30.0) -> dict:
    """The destination side of a PEER pull: fetch the covering prefix
    blocks named by ``pull`` (``{"host", "port", "tokens"}``) from a
    sibling replica's cache over ``/kv_export`` tokens mode, and install
    them into this pool's prefix trie tagged ``origin="peer"``.
    One-phase and read-only on the source: there is no park and no ACK
    — the source keeps its copy, the destination gains one. -> meta
    ``{"bytes", "blocks", "installed", "seconds"}`` for the response's
    ``fleet_pull`` block. Raises :class:`MigrationError` with
    ``kind="kv_pull_failed"`` on ANY failure (an injected fault, source
    dead mid-transfer, malformed payload, pool exhausted) — the caller
    degrades to a cold prefill, never errors the request: a peer pull is
    an optimization, not a dependency. ``replica.kv_pull`` is armed at
    entry."""
    if not isinstance(pull, dict):
        raise MigrationError("pull_from must be an object",
                             kind="kv_pull_failed")
    try:
        port = int(pull["port"])
        tokens = [int(t) for t in pull["tokens"]]
    except (KeyError, TypeError, ValueError):
        raise MigrationError(
            "peer pull_from requires integer 'port' and a token list",
            kind="kv_pull_failed")
    host = str(pull.get("host", "127.0.0.1"))
    tid = pull.get("trace_id")
    body = {"tokens": tokens}
    if tid:
        body["trace_id"] = tid
    t0 = time.monotonic()
    try:
        faults.point("replica.kv_pull")
    except faults.InjectedFault as e:
        raise MigrationError(f"kv_pull injected fault: {e}",
                             kind="kv_pull_failed")
    try:
        status, wire = _post_json(host, port, "/kv_export", body,
                                  timeout_s)
    except Exception as e:
        raise MigrationError(
            f"peer kv_export from {host}:{port} failed: "
            f"{type(e).__name__}: {e}", kind="kv_pull_failed")
    if status != 200:
        raise MigrationError(
            f"peer kv_export from {host}:{port} answered {status}: "
            f"{wire.get('error') if isinstance(wire, dict) else wire}",
            kind="kv_pull_failed")
    try:
        tokens_out, layers, nbytes = decode_wire(wire)
        installed = scheduler.install_pulled(tokens_out, layers, nbytes)
    except MigrationError as e:
        raise MigrationError(str(e), kind="kv_pull_failed")
    except faults.InjectedFault as e:
        raise MigrationError(f"kv_pull install injected fault: {e}",
                             kind="kv_pull_failed")
    except KVBlocksExhausted as e:
        raise MigrationError(
            f"kv_pull install found no free blocks: {e}",
            kind="kv_pull_failed")
    except ValueError as e:
        raise MigrationError(
            f"kv_pull install rejected the payload: {e}",
            kind="kv_pull_failed")
    nblocks = int(layers[0]["k"].shape[0]) if layers else 0
    return {"bytes": nbytes, "blocks": nblocks, "installed": installed,
            "seconds": time.monotonic() - t0}
