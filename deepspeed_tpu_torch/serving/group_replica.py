"""Tensor-parallel replicas behind the router (the port's counterpart of
the JAX package's one controller driving a replica on a sub-mesh).

In JAX one controller steps every replica, each on its own sub-mesh. In
the port a tp replica is one process a rank, so a replica is a **rank
group**: the ranks of one ``tp`` group of an inference engine's ``data x
tp`` mesh (``init_inference(tensor_parallel={"tp_size": N})`` on a world
of ``data x N`` ranks: data group ``d`` is replica ``d``). Rank 0 is the
**controller**: it runs the router (and the fleet manager) and holds one
:class:`GroupReplica` proxy a group, with the replica surface the router
and the migrator use (``submit``, ``step``, ``gauges``, ``stats``,
``cancel``, ``export_sequence`` / ``import_sequence`` / ``migrate_out``,
``config``, ``buckets``, and ``telemetry``: the controller's group's
manager, whose first rank the controller is). Every other rank runs
:func:`serve_group`, a follower loop, until the controller stops it.

**How a call reaches a group.** The controller sends the call to the
group's first rank (its leader) as a pickled object over a gloo process
group (point to point, the world's own when it is gloo); the leader
forwards it to the other ranks of its group, every rank of the group runs
it on its own :class:`~deepspeed_tpu_torch.serving.engine.ServingEngine`
in lockstep (the tp collectives inside the forward pair them), and the
leader sends the result back. For the controller's own group the
controller is the leader. Every wait names its own timeout, so an idle
controller never trips a process-group timeout in a follower.

**Requests and clocks.** ``submit`` returns a controller-side
:class:`~deepspeed_tpu_torch.serving.request.Request`; each call's reply
carries every tracked request's changes (new tokens with the ``done``
flag their stream saw, state, reason, timestamps, counters), which the
proxy applies to its requests, streaming the tokens through their
callbacks, so the router's dedupe, failover replay and
``replay_divergence`` see what a one-process replica gives. The
controller's ``clock`` is the one that counts: each call carries its
reading, and the group's engines read it as their clock.

**Death.** A call that gets no reply within ``timeout`` seconds raises
:class:`GroupLost` (``replica_dead``): the router marks the replica
``DEAD`` and replays its work elsewhere, and the proxy never calls the
group again. A replica the router declares dead (a crash, or a breaker
giving up) is released: its ranks drop their server and wait, idle, in
the follower loop; :class:`GroupReplicaFactory` (the fleet manager's
scale-up seam) builds a replica on an idle group, and raises when none is
left, which the fleet manager records as a failed factory build, as with
any factory.

**Migration.** Between two group replicas of the same ``tp``, a sequence
moves as one chunk a rank: ``export_sequence`` has every source rank keep
its head shard of the covered blocks' rows (heads ``[r * H / tp, (r + 1)
* H / tp)`` on rank ``r``); ``import_sequence`` has source rank ``r``
send its chunk to target rank ``r``, which imports it into its pools, as
JAX moves one leaf a cache leaf split into per-tp-shard chunks.
``wire_bytes`` counts every chunk. A replica of another ``tp`` (or a
one-process replica) refuses the import (None), as JAX's migrator does on
a mismatched layout signature.
"""

import datetime
import pickle
import time
from typing import Dict, List, Optional

import torch

from deepspeed_tpu_torch.serving.request import Request
from deepspeed_tpu_torch.serving.router import ReplicaFactory

CONTROLLER = 0
# the request fields a reply mirrors onto the controller's Request
MIRROR = ("state", "finish_reason", "submit_ts", "admit_ts",
          "first_token_ts", "finish_ts", "slot", "length", "cached_len",
          "prefix_hit_tokens", "blocks_shared", "prefill_chunks",
          "draft_tokens", "accepted_tokens", "max_new_tokens",
          "deadline_ms")


class GroupLost(RuntimeError):
    """A rank group stopped answering: the router's fatal failure."""

    replica_dead = True


class GroupWorld:
    """The rank groups of an engine's ``data x tp`` mesh and the channel
    between them (built on every rank, in the same order)."""

    def __init__(self, engine, timeout: float = 60.0):
        import torch.distributed as dist

        self.dist = dist
        self.engine = engine
        self.rank = dist.get_rank()
        self.groups: List[List[int]] = engine.topo.comm_lists("tp")
        self.group = next(g for g, ranks in enumerate(self.groups)
                          if self.rank in ranks)
        self.timeout = float(timeout)
        self.pg = (None if dist.get_backend() == "gloo"
                   else dist.new_group(backend="gloo"))
        # controller-side: group -> "idle" | "active" | "lost" | "stopped"
        self.states = ["idle"] * len(self.groups)

    @property
    def tp(self) -> int:
        return len(self.groups[0])

    def leader(self, group: int) -> int:
        return self.groups[group][0]

    # -- point to point ----------------------------------------------
    # every wait names its own timeout (a day where none is given), so
    # an idle controller never trips the process group's in a follower;
    # gloo closes a pair whose wait timed out, so a lost group is never
    # called again
    def _wait(self, work, timeout: Optional[float]):
        try:
            work.wait(datetime.timedelta(
                seconds=timeout if timeout is not None else 86400.0))
        except RuntimeError as e:
            raise GroupLost(f"no answer within {timeout} s: {e}") from e

    def send(self, obj, dst: int, timeout: Optional[float] = None):
        data = bytearray(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
        size = torch.tensor([len(data)], dtype=torch.int64)
        buf = torch.frombuffer(data, dtype=torch.uint8)
        for t in (size, buf):
            self._wait(self.dist.isend(t, dst, group=self.pg), timeout)

    def recv(self, src: int, timeout: Optional[float] = None):
        size = torch.zeros(1, dtype=torch.int64)
        self._wait(self.dist.irecv(size, src, group=self.pg), timeout)
        buf = torch.empty(int(size[0]), dtype=torch.uint8)
        self._wait(self.dist.irecv(buf, src, group=self.pg), timeout)
        return pickle.loads(buf.numpy().tobytes())

    # -- the controller's calls ----------------------------------------
    def call(self, calls: Dict[int, tuple]) -> Dict[int, object]:
        """Run ``{group: message}`` on their groups (at once: a group the
        controller is not in gets its message first) and return each
        group's reply. A group that does not answer raises
        :class:`GroupLost` naming it (``.group``)."""
        assert self.rank == CONTROLLER
        remote = [g for g in calls if g != self.group]
        for g in remote:
            self._guard(g, lambda: self.send(calls[g], self.leader(g),
                                             self.timeout))
        out = {}
        if self.group in calls:
            out[self.group] = self.member.run(calls[self.group])
        for g in remote:
            out[g] = self._guard(g, lambda: self.recv(self.leader(g),
                                                      self.timeout))
        return out

    def _guard(self, group, fn):
        try:
            return fn()
        except Exception as e:
            self.states[group] = "lost"
            lost = GroupLost(f"rank group {group} {self.groups[group]} "
                             f"lost: {e}")
            lost.group = group
            raise lost from e

    def shutdown(self):
        """Stop every group still reachable (followers return)."""
        for g, state in enumerate(self.states):
            if state in ("idle", "active"):
                self.states[g] = "stopped"
                if g != self.group:
                    try:
                        self.send(("stop",), self.leader(g), self.timeout)
                    except GroupLost:
                        pass
                else:
                    self.member.forward(("stop",))
                    self.member.do_release()


class _Member:
    """One rank's side of its group: the serving engine the group's calls
    run on, the requests it tracks for the controller, and the rows it
    keeps for a migration."""

    def __init__(self, world: GroupWorld, draft_model=None):
        self.world = world
        self.draft_model = draft_model
        self.now = 0.0
        self.server = None
        self.reqs: Dict[str, Request] = {}
        self.sent: Dict[str, int] = {}
        self.flags: Dict[str, List[bool]] = {}
        self.stash = {}

    def clock(self) -> float:
        return self.now

    def forward(self, msg):
        """The leader hands a message to the rest of its group."""
        w = self.world
        if w.rank == w.leader(w.group):
            for r in w.groups[w.group][1:]:
                w.send(msg, r)

    def run(self, msg):
        self.forward(msg)
        if msg[0] != "call":
            return None
        _, method, args, kwargs, now, traces = msg
        self.now = now
        for rid, trace in traces.items():
            if rid in self.reqs and self.reqs[rid].trace is None:
                self.reqs[rid].trace = dict(trace)
        result = getattr(self, "do_" + method)(*args, **kwargs)
        return {"result": result, "deltas": self._deltas()}

    def _track(self, req: Request, sent: int = 0):
        self.reqs[req.request_id] = req
        self.sent[req.request_id] = sent
        self.flags.setdefault(req.request_id, [])

    def _stream(self, rid):
        def cb(_req, _tok, done):
            self.flags[rid].append(bool(done))
        return cb

    def _deltas(self):
        out = {}
        for rid, req in list(self.reqs.items()):
            n = self.sent[rid]
            out[rid] = {"fields": {f: getattr(req, f) for f in MIRROR},
                        "new": list(zip(req.tokens[n:], self.flags[rid]))}
            self.sent[rid] = len(req.tokens)
            self.flags[rid] = []
            if req.done:
                self._untrack(rid)
        return out

    def _untrack(self, rid):
        self.reqs.pop(rid, None)
        self.sent.pop(rid, None)
        self.flags.pop(rid, None)

    # -- the calls ------------------------------------------------------
    def do_build(self):
        from deepspeed_tpu_torch.serving.engine import ServingEngine

        self.server = ServingEngine(self.world.engine, clock=self.clock,
                                    draft_model=self.draft_model)
        return {"buckets": list(self.server.buckets),
                "max_len": self.server.max_len}

    def do_release(self):
        if self.server is not None:
            self.server.destroy()
        self.server = None
        self.reqs.clear()
        self.sent.clear()
        self.flags.clear()
        self.stash.clear()

    def do_submit(self, prompt, **kwargs):
        rid = kwargs["request_id"]
        self.flags[rid] = []
        req = self.server.submit(prompt, stream=self._stream(rid), **kwargs)
        self._track(req)
        return None

    def do_step(self):
        return [r.request_id for r in self.server.step()]

    def do_gauges(self):
        return self.server.gauges()

    def do_stats(self):
        return self.server.stats()

    def do_cancel(self, request_id, reason="cancelled"):
        return self.server.cancel(request_id, reason)

    def do_export_sequence(self, request_id):
        """Every rank keeps its chunk; the leader returns the metadata
        with the group's wire bytes (every chunk's)."""
        self.stash.clear()
        export = self.server.export_sequence(request_id)
        if export is None:
            return None
        self.stash[request_id] = (export["rows"], export["dtypes"])
        mine = torch.tensor([export["wire_bytes"]], dtype=torch.int64)
        self.world.dist.all_reduce(
            mine, group=self.world.engine.topo.get_tensor_parallel_group())
        meta = {k: v for k, v in export.items() if k != "rows"}
        meta["wire_bytes"] = int(mine[0])
        meta["shard_bytes"] = int(export["wire_bytes"])
        return meta

    def do_send_chunks(self, request_id, targets):
        """Source rank ``r`` sends its chunk to target rank ``r``."""
        rows = self.stash.pop(request_id, None)
        pos = self.world.groups[self.world.group].index(self.world.rank)
        self.world.send(rows, targets[pos])

    def do_import_sequence(self, meta, sources, **kwargs):
        pos = self.world.groups[self.world.group].index(self.world.rank)
        rows, dtypes = self.world.recv(sources[pos])
        rid = kwargs.get("request_id") or meta["request_id"]
        self.flags[rid] = []
        req = self.server.import_sequence(
            {**meta, "rows": rows, "dtypes": dtypes,
             "wire_bytes": meta["wire_bytes"]},
            stream=self._stream(rid), **kwargs)
        if req is None:
            self.flags.pop(rid, None)
            return None
        self._track(req, sent=len(req.tokens))
        return {"tokens": list(req.tokens)}

    def do_migrate_out(self, request_id):
        self._untrack(request_id)
        return self.server.migrate_out(request_id)

    def do_collect_chunks(self, request_id):
        """Every rank's kept chunk, gathered at the leader (a test's
        view of the wire form)."""
        chunk = self.stash.get(request_id)
        group_pg = self.world.engine.topo.get_tensor_parallel_group()
        out = [None] * self.world.tp
        self.world.dist.all_gather_object(out, chunk, group=group_pg)
        return out

    def do_synchronize(self):
        """Wait for the rank's queued device work (timing a call)."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def do_die(self):
        """Stop answering, as a killed group does (tests)."""
        raise _Die()


class _Die(Exception):
    pass


def serve_group(world: GroupWorld):
    """A follower rank's loop: run its group's calls until the
    controller stops it (or, for tests, the group dies)."""
    member = world.member
    leader = world.leader(world.group)
    src = CONTROLLER if world.rank == leader else leader
    while True:
        msg = world.recv(src)
        if msg[0] == "stop":
            member.forward(msg)
            member.do_release()
            return
        try:
            reply = member.run(msg)
        except _Die:
            return
        if world.rank == leader:
            world.send(reply, CONTROLLER)


class GroupReplica:
    """The controller's proxy of one rank group's serving engine (module
    docstring)."""

    def __init__(self, world: GroupWorld, group: int, clock=time.monotonic):
        self.world = world
        self.group = group
        self.clock = clock
        self.tp = world.tp
        self.config = world.engine._serving_cfg
        self._reqs: Dict[str, Request] = {}
        self._traces_sent = set()
        self.dead = False
        info = self._call("build")
        world.states[group] = "active"
        self.buckets = info["buckets"]
        self.max_len = info["max_len"]
        # the group's manager where its first rank is the controller
        # (the router falls back to its first replica's)
        self.telemetry = (world.engine.telemetry if group == world.group
                          else None)

    def __repr__(self):
        return (f"GroupReplica(group={self.group}, "
                f"ranks={self.world.groups[self.group]})")

    # -- plumbing ---------------------------------------------------------
    def _message(self, method, *args, **kwargs):
        traces = {rid: r.trace for rid, r in self._reqs.items()
                  if r.trace is not None and rid not in self._traces_sent}
        self._traces_sent.update(traces)
        return ("call", method, args, kwargs, float(self.clock()), traces)

    def _call(self, method, *args, **kwargs):
        if self.dead:
            raise GroupLost(f"rank group {self.group} is gone")
        try:
            reply = self.world.call(
                {self.group: self._message(method, *args, **kwargs)})
        except GroupLost:
            self.dead = True
            raise
        reply = reply[self.group]
        self._apply(reply["deltas"])
        return reply["result"]

    def _apply(self, deltas):
        """Mirror the group's request changes onto the controller's
        requests, streaming the new tokens as the group emitted them."""
        for rid, d in deltas.items():
            req = self._reqs.get(rid)
            if req is None:
                continue
            for f, v in d["fields"].items():
                setattr(req, f, v)
            for tok, done in d["new"]:
                req.emit_token(tok, done)
            if req.done:
                self._reqs.pop(rid, None)
                self._traces_sent.discard(rid)

    # -- the replica surface ----------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 0, request_id=None,
               stream=None, **kwargs) -> Request:
        prompt = [int(t) for t in prompt]
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      stream=stream, **({"request_id": request_id}
                                        if request_id else {}), **kwargs)
        self._reqs[req.request_id] = req
        self._call("submit", prompt, max_new_tokens=int(max_new_tokens),
                   request_id=req.request_id, **kwargs)
        return req

    def step(self) -> List[Request]:
        live = dict(self._reqs)
        finished = self._call("step")
        return [live[rid] for rid in finished if rid in live]

    def gauges(self) -> dict:
        return self._call("gauges")

    def stats(self) -> dict:
        return self._call("stats")

    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        if self.dead:
            return False
        return self._call("cancel", request_id, reason)

    # -- live migration: one chunk a rank ------------------------------
    def export_sequence(self, request_id: str) -> Optional[dict]:
        meta = self._call("export_sequence", request_id)
        if meta is None:
            return None
        return {**meta, "source_group": (self.world, self.group),
                "tp": self.tp}

    def import_sequence(self, export: Optional[dict], deadline_ms=None,
                        stream=None, request_id: Optional[str] = None,
                        trace: Optional[dict] = None) -> Optional[Request]:
        if export is None or self.dead:
            return None
        src = export.get("source_group")
        if (src is None or src[0] is not self.world
                or export.get("tp") != self.tp):
            return None  # another layout: refused, as JAX's migrator does
        source = src[1]
        rid = request_id or export["request_id"]
        meta = {k: v for k, v in export.items()
                if k not in ("source_group", "tp")}
        req = Request(prompt=list(export["prompt"]), request_id=rid,
                      stream=stream)
        req.tokens = list(export["tokens"])
        if trace is not None:
            req.trace = dict(trace)
            self._traces_sent.add(rid)
        self._reqs[rid] = req
        w = self.world
        kwargs = {"deadline_ms": deadline_ms, "request_id": rid,
                  "trace": dict(trace) if trace is not None else None}
        msgs = {self.group: self._message(
                    "import_sequence", meta, w.groups[source], **kwargs),
                source: ("call", "send_chunks",
                         (export["request_id"], w.groups[self.group]), {},
                         float(self.clock()), {})}
        try:
            replies = w.call(msgs)
        except GroupLost as e:
            self._reqs.pop(rid, None)
            if getattr(e, "group", None) == self.group:
                self.dead = True
            raise
        reply = replies[self.group]
        if reply["result"] is None:
            self._reqs.pop(rid, None)
            return None
        self._apply(reply["deltas"])
        return req

    def migrate_out(self, request_id: str) -> bool:
        self._reqs.pop(request_id, None)
        return self._call("migrate_out", request_id)

    def synchronize(self):
        """Every rank of the group waits for its device work."""
        self._call("synchronize")

    def collect_chunks(self, request_id: str) -> list:
        """Each rank's chunk of the last export, in rank order."""
        return self._call("collect_chunks", request_id)

    # -- lifecycle -------------------------------------------------------
    def release(self):
        """The router declared this replica dead: its ranks drop their
        server and wait idle in the follower loop (a factory may build on
        them again)."""
        if self.dead:
            return
        self.dead = True
        try:
            self.world.call({self.group: ("call", "release", (), {},
                                          float(self.clock()), {})})
            self.world.states[self.group] = "idle"
        except GroupLost:
            pass

    def kill(self):
        """Make a group other than the controller's stop answering, as a
        group whose ranks died does (tests)."""
        assert self.group != self.world.group
        self.world.send(("call", "die", (), {}, 0.0, {}),
                        self.world.leader(self.group))

    def destroy(self):
        self.world.shutdown()


class GroupReplicaFactory(ReplicaFactory):
    """The fleet manager's scale-up seam over rank groups: builds a
    replica on the first idle group (its ranks wait in the follower
    loop); raises when none is left, as a factory out of capacity does.
    Cold: an idle group's ranks may not have built its kernels yet."""

    def __init__(self, world: GroupWorld, clock=time.monotonic):
        self.world = world
        self.clock = clock

    def build(self):
        idle = [g for g, s in enumerate(self.world.states) if s == "idle"]
        if not idle:
            raise RuntimeError(
                f"no idle rank group left: all {len(self.world.groups)} "
                f"groups of tp {self.world.tp} serve or are lost")
        return GroupReplica(self.world, idle[0], clock=self.clock)


def group_replicas(engine, active: Optional[int] = None, clock=time.monotonic,
                   timeout: float = 60.0, draft_model=None):
    """Every rank: the rank groups of ``engine``'s ``data x tp`` mesh.
    On the controller (rank 0) returns ``(proxies, factory)``: proxies of
    the first ``active`` groups (all by default), each group's server
    built, and a factory over the rest. On every other rank serves its
    group until the controller stops it, then returns None."""
    world = GroupWorld(engine, timeout=timeout)
    world.member = _Member(world, draft_model=draft_model)
    if world.rank != CONTROLLER:
        serve_group(world)
        return None
    n = len(world.groups) if active is None else int(active)
    proxies = [GroupReplica(world, g, clock=clock) for g in range(n)]
    return proxies, GroupReplicaFactory(world, clock=clock)
