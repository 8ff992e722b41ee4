"""Command-line entrypoint: ``python -m sitewhere_tpu_torch <command>``.

Counterpart of `sitewhere_tpu/__main__.py`. The reference ships each
microservice as a runnable Spring Boot app (sitewhere-microservice
MicroserviceApplication.java:40 — process entry, start() at :49); here the
whole platform composes into one process on one card, so the CLI boots the
single-process instance the same way an operator would boot the
reference's docker-compose stack.

Commands:

  serve    boot a SiteWhereInstance + REST gateway on the card
           (`--device cpu` / `pipeline.device` asks for the CPU; without
           CUDA and without it, serve refuses to boot)
  openapi  print the generated OpenAPI 3 document and exit
  check    environment self-check: torch, the CUDA device, nvcc, a build
           of each CUDA kernel and of the native host library
  version  print the package version
  deadletters / assemble-checkpoint  as in the reference

One card a host. `serve` also takes the networked bus edge
(`--bus-port`), the feeder fleet's landing zone on it (`--feeders`), a
feeder worker (`serve --feeder`: host work only, no card), the
control-plane cluster (`--cluster-peers` without a coordinator), the
gang-restart supervisor (`--supervise`) and usage telemetry
(`telemetry.*`). `--shards N` runs the sharded pipeline (N shards of the
device population in card blocks over every visible card, the reference's
one shard a device; `--device cuda:i` holds them all on card i).
`--cluster-coordinator host:port` with
`--cluster-num-processes`, `--cluster-process-id` and `--cluster-peers`
boots one host of the multi-host data plane (parallel/cluster.py
ClusterService): the processes join a gloo world at the coordinator,
`--shards` counts the global shards (one a process when left at 1), and
each process holds its block of them on its own `--device` (two processes
on one card both use cuda:0).

Configuration layers (runtime/config.py — the CLI uses the canonical
``DEFAULTS`` schema there): built-in defaults <- --config JSON file <-
SWTPU_* environment variables <- command-line flags. Example config file:

    {"instance": {"id": "prod"},
     "persist": {"data_dir": "/var/lib/swtpu"},
     "pipeline": {"enabled": true, "device": "cuda",
                  "batch_size": 8192, "max_devices": 131072},
     "api": {"host": "0.0.0.0", "port": 8080}}
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
from typing import Optional


def _build_config(config_path: Optional[str]):
    from sitewhere_tpu_torch.runtime.config import DEFAULTS, Configuration

    return Configuration(defaults=DEFAULTS, config_path=config_path)


def _build_instance(cfg, mesh=None):
    from sitewhere_tpu_torch.instance import SiteWhereInstance

    mode = cfg.get("pipeline.mode") or "throughput"
    if mode not in ("throughput", "latency"):
        raise SystemExit(f"pipeline.mode must be 'throughput' or 'latency',"
                         f" got {mode!r}")
    # latency mode: the engine's compiled batch shape IS the latency
    # lever (pack + H2D + step scale with it); ingest then flushes
    # adaptively (pipeline/feed.py AdaptiveBatcher semantics)
    batch_size = int(cfg.get("pipeline.latency_batch_size")
                     if mode == "latency"
                     else cfg.get("pipeline.batch_size"))
    # boot-armed fault plan (runtime/faults.py): only built when rules
    # are declared, so the default config boots with injection disarmed
    fault_rules = cfg.get("faults.rules") or []
    fault_plan = ({"seed": int(cfg.get("faults.seed") or 0),
                   "rules": [dict(r) for r in fault_rules]}
                  if fault_rules else None)
    return SiteWhereInstance(
        device=cfg.get("pipeline.device") or "cuda",
        instance_id=cfg.get("instance.id"),
        data_dir=cfg.get("persist.data_dir"),
        enable_pipeline=bool(cfg.get("pipeline.enabled")),
        max_devices=int(cfg.get("pipeline.max_devices")),
        max_zones=int(cfg.get("pipeline.max_zones")),
        max_zone_vertices=int(cfg.get("pipeline.max_zone_vertices")),
        batch_size=batch_size,
        measurement_slots=int(cfg.get("pipeline.measurement_slots")),
        max_tenants=int(cfg.get("pipeline.max_tenants")),
        bus_partitions=int(cfg.get("bus.partitions")),
        default_tenant=cfg.get("instance.default_tenant"),
        admin_username=cfg.get("instance.admin_username"),
        admin_password=cfg.get("instance.admin_password"),
        shards=int(cfg.get("mesh.shards")),
        mesh=mesh,
        # "auto" -> None: the engine decides by mesh shape/topology
        device_routing={"on": True, "off": False}.get(
            str(cfg.get("pipeline.device_routing") or "auto").lower()),
        h2d_buffer_depth=int(cfg.get("pipeline.h2d_buffer_depth") or 3),
        checkpoint_interval_s=(
            float(cfg.get("persist.checkpoint_interval_s"))
            if cfg.get("persist.checkpoint_interval_s") is not None
            else None),
        latency_linger_ms=(float(cfg.get("pipeline.linger_ms"))
                           if mode == "latency" else None),
        latency_adaptive=bool(cfg.get("pipeline.adaptive_linger")),
        allow_fault_drills=bool(cfg.get("faults.allow_drills")),
        fault_plan=fault_plan,
        admission_step_budget_ms=(
            float(cfg.get("faults.admission_step_budget_ms"))
            if cfg.get("faults.admission_step_budget_ms") is not None
            else None),
        admission_queue_depth_budget=(
            int(cfg.get("faults.admission_queue_depth_budget"))
            if cfg.get("faults.admission_queue_depth_budget") is not None
            else None),
        trace_sample_n=int(cfg.get("observability.trace_sample_n") or 0),
        serving_workers=int(cfg.get("serving.workers") or 4),
        serving_queue_depth_budget=int(
            cfg.get("serving.queue_depth_budget") or 64),
        serving_latency_budget_ms=float(
            cfg.get("serving.latency_budget_ms") or 0.0),
        serving_cache_mb=float(cfg.get("serving.cache_mb") or 64.0),
        serving_mesh_row_threshold=(
            int(cfg.get("serving.mesh_row_threshold"))
            if cfg.get("serving.mesh_row_threshold") is not None
            else None),
        refit_interval_s=(
            float(cfg.get("actuation.refit_interval_s"))
            if cfg.get("actuation.refit_interval_s") else None))


def _apply_rule_config(instance, cfg) -> None:
    """Install the config-declared fused rules on the booted engine (the
    reference's RuleProcessingParser spring wiring of
    ZoneTestRuleProcessor; the metamodel element is
    runtime/config_model.py rule_processing_model)."""
    rules = cfg.get("rules") or []
    engine = instance.pipeline_engine
    if engine is None:
        if rules:
            print("warning: config declares rules but the pipeline is "
                  "disabled; ignoring", file=sys.stderr)
        return
    from sitewhere_tpu_torch.pipeline.engine import rule_from_dict

    for data in rules:
        if data.get("type") == "scripted":
            _apply_scripted_rule(instance, dict(data))
            continue
        kind, rule = rule_from_dict(dict(data))
        # upsert: config wins over a restored checkpoint's copy of the
        # same token (restore_on_boot runs inside instance.start(),
        # BEFORE this) without duplicating it
        engine.upsert_rule(kind, rule)


def _apply_scripted_rule(instance, data: dict) -> None:
    """Install a config-declared script-backed rule processor on a tenant
    engine (the reference's Groovy ZoneTest-style processors, spring-wired
    there; declared in the same `rules` config list here). Goes through
    the instance's durable install path, so a config-declared rule is
    indistinguishable from a REST-installed one (replicated, restored at
    boot)."""
    from sitewhere_tpu_torch.errors import SiteWhereError

    token = data.get("token") or ""
    script_id = data.get("script") or ""
    if not token or not script_id:
        raise SiteWhereError("scripted rules require 'token' and 'script'")
    tenant = data.get("tenant") or instance._default_tenant or "default"
    engine = instance.get_tenant_engine(tenant)
    if engine is None:
        raise SiteWhereError(f"scripted rule {token!r}: unknown tenant "
                             f"{tenant!r}")
    existing = engine.rule_processors.get_processor(token)
    if existing is not None and getattr(existing, "script_id",
                                        None) == script_id:
        return  # idempotent reboot (boot restore already installed it)
    # config declares desired state: replace whatever is installed
    instance.install_scripted_rule(tenant, token, script_id, replace=True)


def _apply_search_config(instance, cfg) -> None:
    """Register config-declared EXTERNAL search providers on tenant
    engines (the reference's Spring-wired SolrSearchProvider slot;
    metamodel element: runtime/config_model.py event_search_model)."""
    providers = cfg.get("search_providers") or []
    if not providers:
        return
    from sitewhere_tpu_torch.search import HttpSearchProvider

    for data in providers:
        if data.get("type") != "http":
            print(f"warning: unknown search provider type "
                  f"{data.get('type')!r}; skipping", file=sys.stderr)
            continue
        tenant = data.get("tenant") or instance._default_tenant or "default"
        engine = instance.get_tenant_engine(tenant)
        if engine is None:
            print(f"warning: search provider "
                  f"{data.get('provider_id')!r} names unknown tenant "
                  f"{tenant!r}; skipping", file=sys.stderr)
            continue
        engine.search_providers.register(HttpSearchProvider(
            data["provider_id"], data["base_url"],
            name=data.get("name", ""),
            timeout_s=float(data.get("timeout_s", 10.0))))


def cmd_assemble_checkpoint(args) -> int:
    """Merge one per-host shard checkpoint from every cluster host into a
    canonical checkpoint that restores onto any topology (other host
    counts, shard counts, or a single chip)."""
    from sitewhere_tpu_torch.persist.checkpoint import write_assembled

    path = write_assembled(list(args.sources), args.out)
    print(path)
    return 0


def _install_stop_handlers(stop: Optional[threading.Event] = None
                           ) -> threading.Event:
    """SIGINT/SIGTERM set `stop` for a graceful serve-loop exit; the
    handler then restores the DEFAULT disposition, so a second signal
    force-exits — a boot hung inside a blocking call (unreachable
    cluster coordinator, stuck replay) stays killable with a repeated
    Ctrl+C / SIGTERM."""
    stop = stop or threading.Event()

    def _sig(signum, _frame):
        stop.set()
        signal.signal(signum, signal.SIG_DFL)

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    return stop


def _refuse(message: str) -> int:
    print(f"error: {message}", file=sys.stderr, flush=True)
    return 2


def _parse_peers(spec: Optional[str]) -> dict:
    """'0=hostA:9092,1=hostB:9092' -> {0: ("hostA", 9092), ...}."""
    out = {}
    if not spec:
        return out
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        pid, _, addr = part.partition("=")
        host, _, port = addr.rpartition(":")
        out[int(pid)] = (host, int(port))
    return out


def _serve_feeder(cfg) -> int:
    """Run ONE feeder worker process (``serve --feeder``): no instance, no
    engine and no card — connect to the landing host's bus edge, lease
    source partitions, and run decode -> intern -> pack -> ship on the host
    until stopped. Composes with --supervise: a killed feeder restarts with
    a freshly minted epoch, above any floor its previous incarnation was
    fenced at."""
    import os
    import socket

    from sitewhere_tpu_torch.feeders import FeederWorker
    from sitewhere_tpu_torch.runtime.recovery import mint_epoch

    connect = cfg.get("feeders.connect")
    if not connect:
        print("serve --feeder requires --feeder-connect host:port "
              "(the mesh host's bus edge)", file=sys.stderr)
        return 2
    host, _, port = str(connect).rpartition(":")
    name = cfg.get("feeders.name") or f"{socket.gethostname()}:{os.getpid()}"
    spec = cfg.get("feeders.partitions")
    partitions = None
    if spec not in (None, ""):
        partitions = [int(p) for p in str(spec).split(",") if p.strip()]
    epoch = mint_epoch(cfg.get("persist.data_dir"))
    stop = _install_stop_handlers()
    worker = FeederWorker(
        host or "127.0.0.1", int(port), name, epoch=epoch,
        partitions=partitions,
        poll_max_records=int(cfg.get("feeders.poll_max_records")),
        shed_backoff_s=float(cfg.get("feeders.shed_backoff_s")),
        hard_exit=True)
    hello = worker.connect()
    worker.acquire_leases()
    print(f"sitewhere-tpu feeder '{name}' serving", flush=True)
    print(f"  mesh host  : tcp://{connect}", flush=True)
    print(f"  topic      : {hello['topic']} "
          f"({hello['partitions']} partitions)", flush=True)
    print(f"  epoch      : {epoch}", flush=True)
    print(f"  partitions : {sorted(worker.owned) or '(contending)'}",
          flush=True)
    try:
        while not stop.is_set():
            if worker.run_once() == 0 and not worker.owned:
                # nothing leased yet (another worker holds everything):
                # retry acquisition on a lazy cadence instead of spinning
                stop.wait(0.5)
    finally:
        worker.stop()
    return 0


def _start_telemetry(cfg, instance):
    """Opt-in usage telemetry (the MicroserviceAnalytics role; None unless
    telemetry.enabled and telemetry.endpoint are configured)."""
    from sitewhere_tpu_torch.runtime.telemetry import build_from_config

    telemetry = build_from_config(cfg, instance.instance_id)
    if telemetry is not None:
        telemetry.start()
    return telemetry


def _serve_control_plane(cfg) -> int:
    """Boot one host of a control-plane-replicated deployment: a
    single-card instance (its own engine) plus the busnet edge and the
    replication stack — registry gossip, tenant/user provisioning with
    reactive engine lifecycle, script replication, heartbeats. REST
    mutations on any host converge everywhere without restarts; a killed
    host restarts alone (wrap with --supervise) and rebuilds its tenant
    set from checkpoint + durable stores, not templates."""
    from sitewhere_tpu_torch.parallel.cluster import ControlPlaneCluster
    from sitewhere_tpu_torch.web.server import RestServer

    stop = _install_stop_handlers()
    process_id = int(cfg.get("cluster.process_id"))
    peers = _parse_peers(cfg.get("cluster.peers"))
    num_processes = int(cfg.get("cluster.num_processes") or 0) or \
        (len(peers) or 1)
    instance = _build_instance(cfg)
    edge_port = cfg.get("bus.edge_port")
    cluster = ControlPlaneCluster(
        instance, process_id, num_processes,
        peer_bus_addrs=peers,
        bus_host=cfg.get("api.host"),
        bus_port=int(edge_port) if edge_port is not None else 0,
        heartbeat_s=float(cfg.get("cluster.heartbeat_s")),
        stale_after_s=float(cfg.get("cluster.stale_after_s")))
    cluster.start()
    _apply_rule_config(instance, cfg)
    _apply_search_config(instance, cfg)
    telemetry = _start_telemetry(cfg, instance)
    rest = RestServer(instance, host=cfg.get("api.host"),
                      port=int(cfg.get("api.port")),
                      token_expiration_minutes=int(
                          cfg.get("api.jwt_expiration_min")))
    rest.start()

    print(f"sitewhere-tpu control-plane host {process_id}/{num_processes} "
          f"instance '{instance.instance_id}' serving", flush=True)
    print(f"  REST gateway : {rest.base_url}", flush=True)
    print(f"  bus edge     : tcp://{cfg.get('api.host')}:"
          f"{cluster.bus_port}", flush=True)
    print(f"  device       : {instance.device}", flush=True)

    try:
        while not stop.wait(1.0):
            pass
    finally:
        rest.stop()
        cluster.stop()
        if telemetry is not None:
            telemetry.stop()
    return 0


def _serve_cluster(cfg) -> int:
    """Boot one host of an N-process instance: join the gloo world at the
    coordinator, build the instance over the GLOBAL mesh (this process's
    block of `mesh.shards` shards on its device), and compose the cluster
    services (lockstep step loop, busnet edge, foreign-row forwarding,
    heartbeats/topology, peer watchdog) around it (parallel/cluster.py;
    reference boot: Microservice.java:182-236). SIGTERM stops every host's
    loop after the same tick through the stop vote."""
    from sitewhere_tpu_torch.parallel.cluster import ClusterService
    from sitewhere_tpu_torch.parallel.distributed import (
        initialize, make_global_mesh)
    from sitewhere_tpu_torch.web.server import RestServer

    # handlers before the (slow) distributed boot — see cmd_serve
    stop = _install_stop_handlers()

    process_id = int(cfg.get("cluster.process_id"))
    num_processes = int(cfg.get("cluster.num_processes"))
    initialize(coordinator_address=cfg.get("cluster.coordinator"),
               num_processes=num_processes, process_id=process_id)
    # re-assert ours in case the process-group boot installed its own
    _install_stop_handlers(stop)
    # mesh.shards counts the global shards; left at 1, one a process (the
    # reference's one device a host)
    shards = int(cfg.get("mesh.shards"))
    mesh = make_global_mesh(
        n_shards=num_processes if shards == 1 else shards,
        device=cfg.get("pipeline.device") or "cuda")
    instance = _build_instance(cfg, mesh=mesh)
    peers = _parse_peers(cfg.get("cluster.peers"))
    edge_port = cfg.get("bus.edge_port")
    cluster = ClusterService(
        instance, process_id, num_processes,
        peer_bus_addrs=peers,
        bus_host=cfg.get("api.host"),
        bus_port=int(edge_port) if edge_port is not None else 0,
        heartbeat_s=float(cfg.get("cluster.heartbeat_s")),
        stale_after_s=float(cfg.get("cluster.stale_after_s")),
        fail_after_s=float(cfg.get("cluster.fail_after_s")),
        presence_every_ticks=int(cfg.get("cluster.presence_every_ticks")),
        exit_on_peer_loss=bool(cfg.get("cluster.exit_on_peer_loss")),
        peer_loss_exit_code=int(cfg.get("cluster.peer_loss_exit_code")),
        registry_gossip=bool(cfg.get("cluster.registry_gossip")))
    cluster.start()
    # config rules install AFTER cluster.start (the gossip hook is live,
    # but every host boots the same config, so applies are idempotent
    # replace-on-add at the peers)
    _apply_rule_config(instance, cfg)
    _apply_search_config(instance, cfg)
    telemetry = _start_telemetry(cfg, instance)
    rest = RestServer(instance, host=cfg.get("api.host"),
                      port=int(cfg.get("api.port")),
                      token_expiration_minutes=int(
                          cfg.get("api.jwt_expiration_min")))
    rest.start()

    print(f"sitewhere-tpu cluster host {process_id}/{num_processes} "
          f"instance '{instance.instance_id}' serving", flush=True)
    print(f"  REST gateway : {rest.base_url}", flush=True)
    print(f"  bus edge     : tcp://{cfg.get('api.host')}:"
          f"{cluster.bus_port}", flush=True)
    print(f"  mesh         : {mesh.n_shards} shards over {num_processes} "
          f"hosts, shards {mesh.local_shards} on {mesh.device}",
          flush=True)
    if cfg.get("feeders.enabled"):
        # the lockstep loop is the only feeder of a cluster host's engine,
        # as in the reference's cluster serve
        print("  feeders      : not mounted on a cluster host", flush=True)

    _install_stop_handlers(stop)
    try:
        while not stop.wait(1.0):
            if cluster.loop.fatal is not None:
                return 1
    finally:
        rest.stop()
        cluster.stop()
        if telemetry is not None:
            telemetry.stop()
    return 0


def cmd_serve(args) -> int:
    from sitewhere_tpu_torch.device import resolve_device
    from sitewhere_tpu_torch.runtime.busnet import BusServer
    from sitewhere_tpu_torch.web.server import RestServer

    cfg = _build_config(args.config)
    # flags override file/env layers
    if args.data_dir is not None:
        cfg.set("persist.data_dir", args.data_dir)
    if args.port is not None:
        cfg.set("api.port", args.port)
    if args.host is not None:
        cfg.set("api.host", args.host)
    if args.shards is not None:
        cfg.set("mesh.shards", args.shards)
    if args.no_pipeline:
        cfg.set("pipeline.enabled", False)
    if args.device is not None:
        cfg.set("pipeline.device", args.device)
    if args.bus_port is not None:
        cfg.set("bus.edge_port", args.bus_port)
    for flag, key in (("feeder_connect", "feeders.connect"),
                      ("feeder_name", "feeders.name"),
                      ("feeder_partitions", "feeders.partitions")):
        value = getattr(args, flag, None)
        if value is not None:
            cfg.set(key, value)
    if getattr(args, "feeder", False):
        return _serve_feeder(cfg)
    if getattr(args, "feeders", False):
        cfg.set("feeders.enabled", True)
    for flag, key in (("cluster_coordinator", "cluster.coordinator"),
                      ("cluster_num_processes", "cluster.num_processes"),
                      ("cluster_process_id", "cluster.process_id"),
                      ("cluster_peers", "cluster.peers")):
        value = getattr(args, flag, None)
        if value is not None:
            cfg.set(key, value)
    try:
        resolve_device(cfg.get("pipeline.device") or "cuda")
    except RuntimeError as exc:
        return _refuse(f"{exc} (serve --device cpu; no CUDA fallback)")
    if cfg.get("cluster.coordinator"):
        return _serve_cluster(cfg)
    if cfg.get("cluster.peers") and cfg.get("cluster.process_id") is not None:
        # peers without a coordinator: control-plane-only cluster — N
        # independent single-card instances whose registries + tenant/
        # user provisioning converge over busnet (parallel/cluster.py
        # ControlPlaneCluster)
        return _serve_control_plane(cfg)

    # graceful-shutdown handlers BEFORE the (slow) boot: a SIGTERM that
    # lands mid-boot or in the window right after the serving banner must
    # stop the loop and exit 0, never die on the default handler
    stop = _install_stop_handlers()

    instance = _build_instance(cfg)
    instance.start()
    _apply_rule_config(instance, cfg)
    _apply_search_config(instance, cfg)
    telemetry = _start_telemetry(cfg, instance)
    rest = RestServer(instance, host=cfg.get("api.host"),
                      port=int(cfg.get("api.port")),
                      token_expiration_minutes=int(
                          cfg.get("api.jwt_expiration_min")))
    rest.start()
    bus_server = None
    edge_port = cfg.get("bus.edge_port")
    if edge_port is not None:
        bus_server = BusServer(instance.bus, host=cfg.get("api.host"),
                               port=int(edge_port))
        bus_server.start()
    feeder_service = None
    if (cfg.get("feeders.enabled") and bus_server is not None
            and instance.pipeline_engine is not None):
        # mount the feeder fleet's landing zone on the bus edge: remote
        # workers lease partitions of the frames topic and this host's
        # per-step work on their blobs shrinks to H2D + the captured step
        from sitewhere_tpu_torch.feeders import FeederService
        from sitewhere_tpu_torch.sources.manager import GLOBAL_ADMISSION
        feeder_service = FeederService(
            instance.pipeline_engine, bus_server,
            frames_topic=(cfg.get("feeders.frames_topic")
                          or instance.naming.feeder_frames()),
            lease_ttl_s=float(cfg.get("feeders.lease_ttl_s")),
            tenant=cfg.get("instance.default_tenant") or "default",
            admission=GLOBAL_ADMISSION)

    print(f"sitewhere-tpu instance '{instance.instance_id}' serving",
          flush=True)
    print(f"  REST gateway : {rest.base_url}", flush=True)
    print(f"  OpenAPI doc  : {rest.base_url}/api/openapi.json", flush=True)
    print(f"  device       : {instance.device}", flush=True)
    engine = instance.pipeline_engine
    if getattr(engine, "n_shards", 1) > 1:
        mesh = engine.mesh
        print(f"  shards       : {engine.n_shards} over {mesh.n_cards} "
              f"card(s) (device routing "
              f"{'on' if engine.device_routing else 'off'})", flush=True)
        for k, card in enumerate(mesh.cards):
            print(f"  card {k:<7} : {card} shards {mesh.shards_on(k)}",
                  flush=True)
    if bus_server is not None:
        print(f"  bus edge     : tcp://{cfg.get('api.host')}:"
              f"{bus_server.port}", flush=True)
    if feeder_service is not None:
        print(f"  feeder fleet : topic {feeder_service.frames_topic} "
              f"(lease ttl {feeder_service.lease_ttl_s:g}s)", flush=True)

    try:
        while not stop.wait(1.0):
            pass
    finally:
        if bus_server is not None:
            bus_server.stop()
        rest.stop()
        instance.stop()
        if telemetry is not None:
            telemetry.stop()
    return 0


def cmd_openapi(args) -> int:
    from sitewhere_tpu_torch.web.openapi import generate_openapi
    from sitewhere_tpu_torch.web.server import RestServer

    import sitewhere_tpu_torch

    cfg = _build_config(args.config)
    # Doc generation needs only the router: no device engine, and no
    # durable state — a data_dir would replay bus segments and open
    # append handles on files a live `serve` process may be writing.
    cfg.set("pipeline.enabled", False)
    cfg.set("persist.data_dir", None)
    cfg.set("pipeline.device", "cpu")  # nothing runs on a device here
    instance = _build_instance(cfg)
    rest = RestServer(instance)  # builds the router; not started
    doc = generate_openapi(rest.router, version=sitewhere_tpu_torch.__version__)
    json.dump(doc, sys.stdout, indent=2)
    print()
    return 0


def cmd_check(_args) -> int:
    """torch and the card, nvcc, a build of each CUDA kernel and of the
    native host library. Exits non-zero when any of them is missing: the
    port runs its kernels on the card and has no fallback."""
    import platform

    import torch

    import sitewhere_tpu_torch
    from sitewhere_tpu_torch import native
    from sitewhere_tpu_torch.ops import cuda_build
    from sitewhere_tpu_torch.ops import geofence_kernel, segsum, stateful

    print(f"sitewhere-tpu-torch {sitewhere_tpu_torch.__version__}")
    print(f"python {platform.python_version()}, torch {torch.__version__} "
          f"(CUDA {torch.version.cuda})")
    ok = True
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        print(f"cuda device: {torch.cuda.get_device_name(0)} x{n}")
        for k in range(n):
            print(f"  card cuda:{k}: {torch.cuda.get_device_name(k)}")
        # serve --shards S spreads over min(S, n) of them (S/K shards a
        # card, K dividing S)
        print(f"  serve --shards S: shards in blocks over min(S, {n}) cards")
    else:
        ok = False
        print("cuda device: MISSING (torch.cuda.is_available() is false; "
              "serve needs --device cpu here)")
    try:
        print(f"nvcc: {cuda_build._nvcc()}")
        names = [geofence_kernel.KERNEL_SOURCE, stateful.KERNEL_SOURCE,
                 segsum.KERNEL_SOURCE]
        cuda_build.build(names)   # every nvcc started together
        for name in names:
            cuda_build.load(name)
            print(f"kernel {name}: ok ({cuda_build.library_path(name).name})")
    except Exception as exc:  # noqa: BLE001 - report, then fail the check
        ok = False
        print(f"cuda kernels: FAILED ({exc})")
    try:
        native.lib()
        print(f"native host runtime: ok ({native.library_path().name})")
    except Exception as exc:  # noqa: BLE001 - report, then fail the check
        ok = False
        print(f"native host runtime: FAILED ({exc})")
    return 0 if ok else 1


def cmd_version(_args) -> int:
    import sitewhere_tpu_torch

    print(sitewhere_tpu_torch.__version__)
    return 0


def cmd_deadletters(args) -> int:
    """Operator loop over parked records on a RUNNING instance (REST):
    list backlogs, inspect records, replay into the reprocess pipeline
    (runtime/deadletter.py; reference: inbound-reprocess-events,
    KafkaTopicNaming.java:48-69)."""
    from sitewhere_tpu_torch.client.rest import SiteWhereClient

    client = SiteWhereClient(args.url)
    client.authenticate(args.username, args.password)
    if args.action == "list":
        topics = client.get("/api/instance/deadletters")["topics"]
        if not topics:
            print("no parked records")
            return 0
        for t in topics:
            print(f"{t['topic']}\n  records={t['records']} "
                  f"backlog={t['replayBacklog']} -> {t['replayTarget']}")
        return 0
    if not args.topic:
        print("error: --topic required for this action", file=sys.stderr)
        return 2
    if args.action == "show":
        out = client.get("/api/instance/deadletters/records",
                         topic=args.topic, limit=args.limit)
        for r in out["records"]:
            print(f"[{r['partition']}:{r['offset']}] key={r['key']} "
                  f"{r['size']}B {json.dumps(r['preview'])}")
        if not out["records"]:
            print("(no records behind the replay cursor)")
        return 0
    if args.action == "replay":
        body = {"topic": args.topic, "max": args.limit}
        if args.target:
            body["target"] = args.target
        out = client.post("/api/instance/deadletters/replay", body)
        print(f"replayed {out['replayed']} -> {out['target']} "
              f"(remaining {out['remaining']})")
        return 0
    print(f"unknown action {args.action}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sitewhere_tpu_torch",
        description="IoT application enablement platform on PyTorch + CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    serve = sub.add_parser("serve", help="boot instance + REST gateway")
    serve.add_argument("--supervise", action="store_true",
                       help="wrap serve in a gang-restart supervisor: an "
                            "abnormal exit (peer loss, crash) restarts "
                            "the process; exit 0 ends supervision")
    serve.add_argument("--supervise-backoff", type=float, default=1.0,
                       help="seconds between restarts (default 1.0)")
    serve.add_argument("--config", help="JSON config file (layered)")
    serve.add_argument("--data-dir", help="durable state directory")
    serve.add_argument("--host", help="bind host (default 127.0.0.1)")
    serve.add_argument("--port", type=int, help="REST port (default 8080)")
    serve.add_argument("--shards", type=int,
                       help="device-mesh shards for the pipeline engine")
    serve.add_argument("--no-pipeline", action="store_true",
                       help="control plane only (no device engine)")
    serve.add_argument("--device",
                       help="torch device of the engine and the read side "
                            "(pipeline.device, default cuda; cpu only "
                            "when asked for)")
    serve.add_argument("--bus-port", type=int,
                       help="expose the event bus on TCP for edge processes")
    serve.add_argument("--feeders", action="store_true",
                       help="landing host: mount the feeder-fleet landing "
                            "zone on the bus edge (feeders.enabled; "
                            "requires --bus-port)")
    serve.add_argument("--feeder", action="store_true",
                       help="run as a FEEDER WORKER process instead of "
                            "an instance: lease source partitions on the "
                            "landing host named by --feeder-connect and "
                            "ship packed wire blobs; host work only "
                            "(decode, intern, pack): it never touches "
                            "CUDA and needs no card (docs/FEEDERS.md)")
    serve.add_argument("--feeder-connect",
                       help="feeder mode: landing host bus edge host:port")
    serve.add_argument("--feeder-name",
                       help="feeder lease identity (default host:pid)")
    serve.add_argument("--feeder-partitions",
                       help="feeder mode: csv partition pin, e.g. '0,1' "
                            "(default: contend for every partition)")
    serve.add_argument("--cluster-coordinator",
                       help="multi-host cluster coordinator host:port "
                            "(process 0 hosts it); enables the multi-host "
                            "data plane")
    serve.add_argument("--cluster-num-processes", type=int,
                       help="total processes in the cluster")
    serve.add_argument("--cluster-process-id", type=int,
                       help="this process's id (0..N-1)")
    serve.add_argument("--cluster-peers",
                       help="peer bus edges: '0=hostA:9092,1=hostB:9092'")
    serve.set_defaults(fn=cmd_serve)

    openapi = sub.add_parser("openapi", help="print the OpenAPI document")
    openapi.add_argument("--config", help="JSON config file")
    openapi.set_defaults(fn=cmd_openapi)

    check = sub.add_parser("check", help="environment self-check")
    check.set_defaults(fn=cmd_check)

    version = sub.add_parser("version", help="print version")
    version.set_defaults(fn=cmd_version)

    assemble = sub.add_parser(
        "assemble-checkpoint",
        help="merge per-host cluster checkpoints into one canonical "
             "checkpoint restorable on ANY topology")
    assemble.add_argument("sources", nargs="+",
                          help="one ckpt-* directory per cluster host")
    assemble.add_argument("--out", required=True,
                          help="checkpoint directory to write into "
                               "(e.g. <data_dir>/checkpoints)")
    assemble.set_defaults(fn=cmd_assemble_checkpoint)

    dl = sub.add_parser("deadletters",
                        help="list/inspect/replay parked records on a "
                             "running instance")
    dl.add_argument("action", choices=["list", "show", "replay"])
    dl.add_argument("--url", default="http://127.0.0.1:8080",
                    help="REST gateway base URL")
    dl.add_argument("--username", default="admin")
    dl.add_argument("--password", default="password")
    dl.add_argument("--topic", help="parked topic (show/replay)")
    dl.add_argument("--target",
                    help="replay destination (default: the reprocess "
                         "topic for decoded events, else the base topic)")
    dl.add_argument("--limit", type=int, default=100,
                    help="records to show / max to replay")
    dl.set_defaults(fn=cmd_deadletters)

    args = parser.parse_args(argv)
    if getattr(args, "supervise", False):
        # re-exec serve (without --supervise) under the gang-restart
        # supervisor (runtime/supervisor.py; the reference's zero-operator
        # recovery analog, MicroserviceKafkaConsumer.java:88 rebalance)
        from sitewhere_tpu_torch.runtime.supervisor import supervise_serve

        raw = list(sys.argv[1:] if argv is None else argv)
        child_argv = []
        skip = False
        for item in raw:
            if skip:
                skip = False
                continue
            if item == "--supervise":
                continue
            if item == "--supervise-backoff":
                skip = True
                continue
            if item.startswith("--supervise-backoff="):
                continue
            child_argv.append(item)
        return supervise_serve(child_argv,
                               backoff_s=args.supervise_backoff)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
