"""One worker process per card: the port's counterpart of the reference's
``jax.sharding.Mesh`` and ``shard_map``.

In the JAX package each chip runs its shard's whole insert, delete, attach
or search as one program of its own (`diskann_tpu/parallel/sharded.py`),
and searches meet once, in ``all_gather``.  Here each card gets a worker
process, started with the ``spawn`` context of `torch.multiprocessing`
(``fork`` is unsafe once CUDA has started), which holds that card's
shards (`sharded._Shards`) and steps them with the in-process lockstep
driver (`sharded._fan_out`).  So every card has a host thread of its own
that issues only its ops, where one thread issuing every card's ops could
not keep four cards busy, and threads in one interpreter handed its lock
back and forth.

- Commands: `Mesh._exchange` sends each worker its command before it reads
  any reply, so the workers run at once; a worker runs its work to the
  end with no round trip per step.  Only the command and its result cross
  the pipe: arguments as numpy arrays, results as numpy arrays (through
  the pipe from the host) or, for a search's CUDA lists and for views the
  caller asks for, as CUDA IPC handles that the caller opens and copies
  from (the peer copy).  Each worker waits for its cards
  before it replies, so a reply means the work is done.
- Errors: a worker replies with its exception, which the caller raises
  with its type kept and the worker's traceback in the message.  A worker
  that dies shows as end-of-file on its pipe or its process sentinel,
  which the caller waits on beside the pipe, so it never hangs; it raises
  `RuntimeError` naming the card and the command, shuts the other workers
  down, and every later call raises too (a sticky CUDA error cannot be
  rolled back either).
- Lifetime: the workers exit when the mesh is collected or the
  interpreter exits (`weakref.finalize`), or when the caller's end of
  their pipe closes.  A sharded index on a mesh holds its shards there
  under a group number; when the index is collected its group is dropped
  with the next command.
"""

from __future__ import annotations

import os
import signal
import time
import traceback
import weakref
from multiprocessing.connection import wait

import numpy as np
import torch

# seconds a worker is given to exit before it is killed
_EXIT_GRACE = 10.0


class _Dataclass:
    """A dataclass holding tensors, on the wire as its type and fields."""

    __slots__ = ("cls", "fields")

    def __init__(self, cls, fields: dict):
        self.cls, self.fields = cls, fields


class _Host:
    """A tensor on the wire as a numpy array (bfloat16 as its int16 bits)."""

    __slots__ = ("array", "bf16")

    def __init__(self, array, bf16: bool):
        self.array, self.bf16 = array, bf16

    def tensor(self) -> torch.Tensor:
        t = torch.from_numpy(self.array)
        return t.view(torch.bfloat16) if self.bf16 else t


def _to_wire(obj, ipc: bool):
    """``obj`` with every tensor made picklable for the pipe: a CUDA tensor
    kept as is with ``ipc`` (pickled as an IPC handle), any other copied to
    a host array."""
    if isinstance(obj, torch.Tensor):
        if ipc and obj.is_cuda:
            return obj
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _Host(t.view(torch.int16).numpy(), True)
        return _Host(t.numpy(), False)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_wire(x, ipc) for x in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_wire(x, ipc) for x in obj)
    if isinstance(obj, dict):
        return {k: _to_wire(v, ipc) for k, v in obj.items()}
    if hasattr(obj, "__dataclass_fields__") and not isinstance(obj, type) and any(
            isinstance(getattr(obj, f), torch.Tensor) for f in obj.__dataclass_fields__):
        return _Dataclass(type(obj), {f: _to_wire(getattr(obj, f), ipc)
                                      for f in obj.__dataclass_fields__})
    return obj


def _from_wire(obj):
    """The inverse of `_to_wire` (host arrays come back as CPU tensors)."""
    if isinstance(obj, _Host):
        return obj.tensor()
    if isinstance(obj, _Dataclass):
        return obj.cls(**{k: _from_wire(v) for k, v in obj.fields.items()})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_from_wire(x) for x in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_wire(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _from_wire(v) for k, v in obj.items()}
    return obj


def _worker(conn, device: torch.device, threads: int, tf32: tuple) -> None:
    """A worker's loop: set up its card, say "ready", then run each command
    it is sent and reply with the result or the exception."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)      # the caller handles ^C
    try:
        torch.set_num_threads(threads)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.ones(1, device=device).sum().item()     # reach the card now
        from diskann_tpu_torch.ops.kernels import native
        from diskann_tpu_torch.parallel.sharded import _Shards
    except BaseException as exc:                          # noqa: BLE001
        conn.send(("err", *_picklable(exc, traceback.format_exc())))
        return
    conn.send(("ok", os.getpid()))
    groups: dict[int, _Shards] = {}
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return                                        # the caller is gone
        cmd = msg[0]
        if cmd == "exit":
            return
        if cmd == "drop":
            for gid in msg[1]:
                groups.pop(gid, None)
            if device.type == "cuda":
                torch.cuda.empty_cache()
            continue
        try:
            if cmd == "new":
                groups[msg[1]] = _Shards(**_from_wire(msg[2]))
                out, ipc = None, False
            elif cmd == "copy":
                groups[msg[2]] = groups[msg[1]].copy()
                out, ipc = None, False
            elif cmd == "call":
                _, gid, method, args, ipc = msg
                out = getattr(groups[gid], method)(*_from_wire(args))
            elif cmd == "run":
                _, gid, fn, args = msg
                out = fn(*(() if gid is None else (groups[gid],)), *_from_wire(args))
                ipc = False
            elif cmd == "launches":
                out = {name: native.launches[name]
                       for name in ("fatrow_expand", "block_patch")}
                if msg[1]:
                    native.reset_launches()
                ipc = False
            else:
                raise ValueError(f"unknown mesh command {cmd!r}")
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            reply = ("ok", _to_wire(out, ipc))
        except BaseException as exc:                      # noqa: BLE001
            text = traceback.format_exc()
            traceback.clear_frames(exc.__traceback__)
            reply = ("err", *_picklable(exc, text))
        try:
            conn.send(reply)
        except Exception as exc:                          # noqa: BLE001
            conn.send(("err", RuntimeError(f"the reply could not be sent: {exc!r}"),
                       traceback.format_exc()))


def _picklable(exc: BaseException, text: str) -> tuple:
    """(an exception that pickles, the traceback text)."""
    import pickle

    try:
        pickle.dumps(exc)
        return exc, text
    except Exception:                                     # noqa: BLE001
        return RuntimeError(f"{type(exc).__name__}: {exc}"), text


def _shutdown(procs: list, conns: list, grace: float = _EXIT_GRACE) -> None:
    """Ask every worker to exit, kill those still alive after ``grace``
    seconds, and close the pipes."""
    for conn in conns:
        try:
            conn.send(("exit",))
        except Exception:                                 # noqa: BLE001
            pass
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join(5.0)
    for conn in conns:
        conn.close()


class Mesh:
    """Worker processes, one per entry of ``devices`` (a CUDA card, or the
    CPU: ``Mesh(["cpu"] * 2)`` gives two workers on the host).

    A `ShardedGraphIndex` built on a mesh puts shard ``s`` in worker ``s``;
    one built on a device list that names several CUDA cards builds a mesh
    of its distinct cards and puts each card's shards in that card's
    worker.  The workers start here (each sets its card and reaches it
    before it says "ready"; one that cannot raises), after the kernel
    library is built once for all of them."""

    def __init__(self, devices):
        from diskann_tpu_torch.parallel.sharded import _resolve

        self.devices = [_resolve(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if any(d.type == "cuda" for d in self.devices):
            from diskann_tpu_torch.ops.kernels import native

            native.build()
        self._broken: str | None = None
        self._pending = [0] * len(self.devices)   # replies owed, per worker
        self._dropped: list[int] = []
        self._next_gid = 0
        ctx = torch.multiprocessing.get_context("spawn")
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        self._procs, self._conns = [], []
        for w, dev in enumerate(self.devices):
            here, there = ctx.Pipe()
            p = ctx.Process(target=_worker, args=(there, dev, torch.get_num_threads(), tf32),
                            name=f"diskann-mesh-{w}-{dev}", daemon=True)
            p.start()
            there.close()
            self._procs.append(p)
            self._conns.append(here)
            self._pending[w] = 1                  # its "ready"
        self._finalizer = weakref.finalize(self, _shutdown, self._procs, self._conns)
        ready = self._gather(range(self.size), "its start")
        for w, reply in ready.items():
            if reply[0] == "err":
                self._finalizer()
                raise _rebuilt(reply[1], reply[2], f"the mesh worker on {self.devices[w]}, "
                                                   "which could not start")
        self.pids = [ready[w][1] for w in range(self.size)]

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    # ------------------------------------------------------------- commands
    def run(self, fn, *args, workers=None) -> list:
        """``fn(*args)`` in each worker (or in those listed), ``fn`` a
        function importable by name there; the results, by worker."""
        ws = range(self.size) if workers is None else workers
        got = self._exchange({w: ("run", None, fn, _to_wire(args, False)) for w in ws},
                             getattr(fn, "__name__", "run"))
        return [got[w] for w in ws]

    def kernel_launches(self, reset: bool = True) -> list:
        """Each worker's kernel launches since its last reset, as
        ``{"fatrow_expand": n, "block_patch": n}``, by worker (then reset
        unless ``reset`` is false)."""
        got = self._exchange({w: ("launches", reset) for w in range(self.size)},
                             "kernel launches")
        return [got[w] for w in range(self.size)]

    def _new_gid(self) -> int:
        self._next_gid += 1
        return self._next_gid

    def _forget(self, gid: int) -> None:
        """Drop group ``gid`` in every worker with the next command (called
        from a finalizer: it sends nothing itself)."""
        self._dropped.append(gid)

    def _exchange(self, msgs: dict, what: str) -> dict:
        """Send each worker its message, then read every reply; raises the
        first worker's exception (by worker order) once all have replied."""
        if self._broken:
            raise RuntimeError(self._broken)
        if self._dropped:
            gone, self._dropped = self._dropped, []
            for w in range(self.size):
                self._send(w, ("drop", gone), what, reply=False)
        for w, msg in msgs.items():
            self._send(w, msg, what)
        replies = self._gather(msgs, what)
        for w, reply in replies.items():
            if reply[0] == "err":
                raise _rebuilt(reply[1], reply[2], f"the mesh worker on {self.devices[w]}")
        return {w: _from_wire(reply[1]) for w, reply in replies.items()}

    def _send(self, w: int, msg: tuple, what: str, *, reply: bool = True) -> None:
        try:
            self._conns[w].send(msg)
        except (BrokenPipeError, ConnectionError, EOFError, OSError):
            self._died(w, what)
        if reply:
            self._pending[w] += 1

    def _gather(self, workers, what: str) -> dict:
        """The reply each of ``workers`` owes for its latest message (older
        replies, owed since a read was interrupted, are skipped), waiting
        on the pipes and the process sentinels together: a worker that
        dies is noticed, never waited for."""
        out, waiting = {}, set(workers)
        while waiting:
            ready = wait([self._conns[w] for w in waiting]
                         + [self._procs[w].sentinel for w in waiting])
            for w in sorted(waiting):
                conn = self._conns[w]
                if conn in ready or conn.poll():
                    try:
                        reply = conn.recv()
                    except (EOFError, OSError):
                        self._died(w, what)
                    self._pending[w] -= 1
                    if self._pending[w] == 0:
                        out[w] = reply
                        waiting.discard(w)
                elif self._procs[w].sentinel in ready:
                    self._died(w, what)
        return out

    def _died(self, w: int, what: str) -> None:
        p = self._procs[w]
        p.join(1.0)
        self._broken = (f"the mesh worker on {self.devices[w]} (pid {p.pid}) died during "
                        f"{what} (exit code {p.exitcode}); this mesh and its indexes "
                        "are unusable")
        self._finalizer.detach()
        _shutdown(self._procs, self._conns, grace=0.0)
        raise RuntimeError(self._broken)


def _rebuilt(exc: BaseException, text: str, where: str) -> BaseException:
    """A worker's exception for the caller: its type kept, the worker's
    traceback in the message."""
    msg = f"{exc} (raised in {where})\n{text}"
    try:
        return type(exc)(msg)
    except Exception:                                     # noqa: BLE001
        return RuntimeError(f"{type(exc).__name__}: {msg}")


class MeshShards:
    """The `sharded._Shards` calls of a sharded index whose shards live in a
    mesh's workers: shard ``s`` in worker ``workers[s]``.  Lists in and out
    hold one entry per shard of the index, in shard order; each worker is
    sent its shards' entries."""

    def __init__(self, mesh: Mesh, workers: list, devices: list, **spec):
        self.mesh = mesh
        self.devices = list(devices)
        self.of = {w: [s for s, ws in enumerate(workers) if ws == w]
                   for w in dict.fromkeys(workers)}
        self.gid = mesh._new_gid()
        mesh._exchange({w: ("new", self.gid, _to_wire(dict(
            ids=ss, devices=[self.devices[s] for s in ss], **spec), False))
            for w, ss in self.of.items()}, "create the shards")
        weakref.finalize(self, mesh._forget, self.gid)

    def _call(self, method: str, per_shard=None, *common, ipc: bool = False) -> dict:
        """``method`` on every worker's shards, each given its entries of
        ``per_shard`` (if any) and ``common``; the replies, by worker."""
        msgs = {}
        for w, ss in self.of.items():
            args = (([per_shard[s] for s in ss],) if per_shard is not None else ()) + common
            msgs[w] = ("call", self.gid, method, _to_wire(args, False), ipc)
        return self.mesh._exchange(msgs, method)

    def _by_shard(self, got: dict) -> list:
        out = [None] * len(self.devices)
        for w, res in got.items():
            for s, r in zip(self.of[w], res):
                out[s] = r
        return out

    def copy(self) -> "MeshShards":
        c = object.__new__(MeshShards)
        c.mesh, c.devices, c.of = self.mesh, self.devices, self.of
        c.gid = self.mesh._new_gid()
        self.mesh._exchange({w: ("copy", self.gid, c.gid) for w in self.of}, "copy")
        weakref.finalize(c, self.mesh._forget, c.gid)
        return c

    def fetch(self, name: str, s: int | None = None):
        """Shard views (CUDA IPC; on the CPU, copies) of ``name``, every
        shard's or shard ``s``'s."""
        if s is None:
            return self._by_shard(self._call("fetch", None, name, ipc=True))
        w = next(w for w, ss in self.of.items() if s in ss)
        got = self.mesh._exchange({w: ("call", self.gid, "fetch", (name, s), True)}, "fetch")
        return got[w]

    def run(self, fn, *args) -> list:
        got = self.mesh._exchange({w: ("run", self.gid, fn, _to_wire(args, False))
                                   for w in self.of}, getattr(fn, "__name__", "run"))
        return [got[w] for w in self.of]

    def grow(self, cap: int) -> None:
        self._call("grow", None, cap)

    def step(self, args: list, name: str) -> list:
        return self._by_shard(self._call("step", args, name))

    def settle(self, ok: bool) -> None:
        self._call("settle", None, ok)

    def train_rows(self, takes: list) -> list:
        return self._by_shard(self._call("train_rows", takes))

    def attach_packed(self, proj, pscale, pbias2) -> None:
        self._call("attach_packed", None, proj, pscale, pbias2)

    def scatter_labels(self, bits) -> None:
        self._call("scatter_labels", None, bits)

    def walk(self, queries, mode, k, l, filt=None, dest=None) -> list:
        if isinstance(queries, torch.Tensor):
            queries = queries.cpu().numpy()
        lists = self._by_shard(self._call("walk", None, np.asarray(queries, np.float32), mode,
                                          k, l, filt, ipc=True))
        return [tuple(t.to(dest) for t in part) for part in lists]

    def host_arrays(self) -> list:
        return self._by_shard(self._call("host_arrays"))

    def write_record(self, path: str) -> None:
        self._call("write_record", None, path)

    def read_record(self, path: str) -> None:
        self._call("read_record", None, path)

    def adopt(self, parts: list) -> None:
        self._call("adopt", parts)

    def adopt_packed(self, parts: list, r_pack: int) -> None:
        self._call("adopt_packed", parts, r_pack)

    def adopt_labels(self, parts: list) -> None:
        self._call("adopt_labels", parts)
