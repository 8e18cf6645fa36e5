"""``python -m repro_torch``: thin arg -> :class:`RunConfig` translators
(counterpart of ``repro.api.cli``).

    python -m repro_torch --list-methods          # method capability matrix
    python -m repro_torch --list-impls            # kernel-impl matrix
    python -m repro_torch ingest  --source data.tnsb --reorder degree_sort
    python -m repro_torch plan    --dataset yelp --scale 0.002 --rank 35
    python -m repro_torch fit     --config run.json [--dryrun]
    python -m repro_torch serve   --dataset yelp --scale 0.002 --queries 2048
    python -m repro_torch fit     --dataset yelp --trace-dir artifacts/trace
    python -m repro_torch trace   artifacts/trace   # Table-III breakdown
    python -m repro_torch metrics artifacts/trace   # metrics table
    python -m repro_torch fit     --dataset yelp --trace-dir t --http-port 9100
    python -m repro_torch serve-daemon --source data.tnsb --port 8080
    python -m repro_torch dryrun  --workload cpals-yelp [--mesh multi]
    torchrun --nproc-per-node N python -m repro_torch fit --executor dist ...

Every subcommand builds one RunConfig (``--config file.json`` loads a base;
explicit flags override it field by field) and drives a
:class:`~repro_torch.api.Session`.  The same argv gives the same RunConfig
as ``python -m repro``.  ``--device`` (default: the CUDA card) is the
Session's, not the config's; ``--device cpu`` runs on the CPU.  The JAX
package's ``ratchet`` subcommand delegates to its ``benchmarks.ratchet``,
and the benchmark folder has no port (ROADMAP §1 item 9), so neither does
the subcommand.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

from .config import ConfigError, RunConfig


# ---------------------------------------------------------------------------
# capability matrices (sourced from the registries, never hand-maintained)
# ---------------------------------------------------------------------------


def _table(rows: list[dict]) -> str:
    cols = list(rows[0]) if rows else []
    widths = {c: max(len(c), *(len(str(r[c])) for r in rows)) for c in cols}
    line = lambda r: "| " + " | ".join(
        str(r[c]).ljust(widths[c]) for c in cols) + " |"
    sep = "|" + "|".join("-" * (widths[c] + 2) for c in cols) + "|"
    return "\n".join([line({c: c for c in cols}), sep] + [line(r) for r in rows])


def list_methods() -> str:
    """Method capability matrix + executor matrix, from the registries."""
    from repro_torch.methods import METHODS

    from .executor import executor_matrix

    rows = [{
        "method": name, "family": s.family, "kernel": s.kernel,
        "dist": "y" if s.supports_dist else "-",
        "streaming": "y" if s.supports_streaming else "-",
        "nonneg": "y" if s.nonnegative else "-",
        "order>3": "y" if s.supports_order_gt3 else "-",
    } for name, s in METHODS.items()]
    ex_rows = [{
        "executor": r["executor"], "requires": r["requires"],
        "methods": " ".join(r["methods"]), "description": r["description"],
    } for r in executor_matrix()]
    return ("# methods (repro_torch.methods registry)\n" + _table(rows)
            + "\n\n# executors (repro_torch.api registry)\n"
            + _table(ex_rows))


def list_impls() -> str:
    """Kernel-impl capability matrix for both registries (mttkrp + ttmc)."""
    from repro_torch.core import REGISTRY, TTMC_REGISTRY

    out = []
    for kernel, reg in (("mttkrp", REGISTRY), ("ttmc", TTMC_REGISTRY)):
        rows = [{
            "impl": name, "layout": s.layout,
            "sorted": "y" if s.needs_sorted else "-",
            "order>3": "y" if s.supports_order_gt3 else "-",
            "backend": s.backend,
            "notes": ("benchmark-only" if s.benchmark_only
                      else "oracle" if s.oracle else "-"),
        } for name, s in reg.items()]
        out.append(f"# {kernel} impls (repro_torch.core registry)\n"
                   + _table(rows))
    return "\n\n".join(out)


# ---------------------------------------------------------------------------
# arg -> RunConfig
# ---------------------------------------------------------------------------


def _add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None, metavar="FILE.json",
                   help="RunConfig JSON to start from (flags override)")
    g = p.add_argument_group("data")
    g.add_argument("--source", default=None, help=".tns/.tnsb path")
    g.add_argument("--dataset", default=None,
                   help="synthetic paper replica (yelp/nell-2/netflix/...)")
    g.add_argument("--scale", type=float, default=None)
    g.add_argument("--data-seed", type=int, default=None)
    g.add_argument("--reorder", default=None)
    g.add_argument("--compact", action="store_true", default=None)
    g.add_argument("--cache", default=None, help="ingest cache root")
    g = p.add_argument_group("plan")
    g.add_argument("--impl", default=None,
                   help="planner policy: auto or a registered impl name")
    g.add_argument("--calibrate", action="store_true", default=None)
    g.add_argument("--recalibrate", action="store_true", default=None,
                   help="force a fresh measured pass, overwriting the "
                        "persisted autotune entry (implies --calibrate)")
    g = p.add_argument_group("method")
    g.add_argument("--method", default=None)
    g.add_argument("--rank", type=int, nargs="+", default=None,
                   help="int, or one int per mode (Tucker)")
    g.add_argument("--iters", type=int, default=None)
    g.add_argument("--tol", type=float, default=None)
    g.add_argument("--seed", type=int, default=None)
    g.add_argument("--option", action="append", default=[], metavar="K=V",
                   help="method option, JSON-valued (e.g. --option decay=0.9)")
    g = p.add_argument_group("exec")
    g.add_argument("--executor", default=None,
                   choices=["local", "dist", "streaming"])
    g.add_argument("--checkpoint-dir", default=None)
    g.add_argument("--checkpoint-every", type=int, default=None)
    g.add_argument("--monitor", action="store_true", default=None)
    g.add_argument("--n-chunks", type=int, default=None)
    g.add_argument("--chunk-nnz", type=int, default=None)
    g = p.add_argument_group("obs")
    g.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="record a span trace + metrics there "
                        "(implies obs.enabled; read back with "
                        "`python -m repro_torch trace DIR`)")
    g.add_argument("--trace-split", action="store_true", default=None,
                   help="trace the paper's full Table-III routine set "
                        "(ata/inverse/norm/fit) instead of the low-overhead "
                        "fused sort/mttkrp/epilogue split")
    g.add_argument("--http-port", type=int, default=None, metavar="PORT",
                   help="serve live /metrics + /healthz + /trace on "
                        "127.0.0.1:PORT for the duration of fit/serve "
                        "(implies obs.enabled; 0 = ephemeral port)")
    g.add_argument("--heartbeat-s", type=float, default=None, metavar="S",
                   help="atomically rewrite <trace-dir>/heartbeat.json "
                        "(metrics + recent events) every S seconds "
                        "(needs --trace-dir)")
    g.add_argument("--events-buffer", type=int, default=None, metavar="N",
                   help="flight-recorder ring capacity (events kept for "
                        "crash dumps / events.jsonl; default 1024)")
    g = p.add_argument_group("serve")
    g.add_argument("--port", type=int, default=None, metavar="PORT",
                   help="serve-daemon HTTP port (0 = ephemeral)")
    g.add_argument("--tenants", nargs="+", default=None, metavar="ID",
                   help="tenant ids to publish the fit under "
                        "(default: default)")
    g.add_argument("--serve-workers", type=int, default=None, metavar="N",
                   help="batch-executing worker threads")
    g.add_argument("--max-wait-ms", type=float, default=None, metavar="MS",
                   help="batch coalescing window from the first request")
    g.add_argument("--buckets", type=int, nargs="+", default=None,
                   metavar="N", help="padded batch-size buckets "
                                     "(strictly increasing)")
    g.add_argument("--budget-mb", type=float, default=None, metavar="MB",
                   help="registry resident-bytes LRU eviction budget")


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="where the run executes: cuda (default, the card) "
                        "or cpu; not part of the RunConfig")


def config_from_args(args: argparse.Namespace) -> RunConfig:
    """Layer CLI flags over (--config base or defaults), then validate once
    through RunConfig.from_dict so every error carries its field path."""
    if args.config:
        from pathlib import Path

        try:
            base = json.loads(Path(args.config).read_text())
        except OSError as e:
            raise ConfigError(f"--config {args.config}: {e}") from None
        except json.JSONDecodeError as e:
            raise ConfigError(
                f"--config {args.config}: not valid JSON ({e})") from None
        if not isinstance(base, dict):
            raise ConfigError(
                f"--config {args.config}: wants a JSON object, got "
                f"{type(base).__name__}")
    else:
        base = {}
    for section in ("data", "plan", "method", "exec", "obs", "serve"):
        base.setdefault(section, {})
        if not isinstance(base[section], dict):
            # catch before flag overlay: put() below would TypeError on it
            raise ConfigError(
                f"--config {args.config}: {section}: wants a mapping, got "
                f"{type(base[section]).__name__}")

    def put(section: str, key: str, val) -> None:
        if val is not None:
            base[section][key] = val

    put("data", "source", args.source)
    put("data", "dataset", args.dataset)
    put("data", "scale", args.scale)
    put("data", "seed", args.data_seed)
    put("data", "reorder", args.reorder)
    put("data", "compact", args.compact)
    put("data", "cache", args.cache)
    put("plan", "policy", args.impl)
    put("plan", "calibrate", args.calibrate)
    if getattr(args, "recalibrate", None):
        # the escape hatch implies a calibration run — setting only
        # plan.recalibrate would trip PlanConfig's requires-calibrate check
        base["plan"]["calibrate"] = True
        base["plan"]["recalibrate"] = True
    put("method", "name", args.method)
    if args.rank is not None:
        put("method", "rank",
            args.rank[0] if len(args.rank) == 1 else tuple(args.rank))
    put("method", "niters", args.iters)
    put("method", "tol", args.tol)
    put("method", "seed", args.seed)
    if args.option:
        opts = dict(base["method"].get("options", {}))
        for kv in args.option:
            k, sep, v = kv.partition("=")
            if not sep or not k:
                raise ConfigError(
                    f"--option {kv!r}: expected KEY=VALUE "
                    "(e.g. --option decay=0.9)")
            try:
                opts[k] = json.loads(v)
            except json.JSONDecodeError:
                opts[k] = v
        base["method"]["options"] = opts
    put("exec", "executor", args.executor)
    put("exec", "checkpoint_dir", args.checkpoint_dir)
    put("exec", "checkpoint_every", args.checkpoint_every)
    put("exec", "monitor", args.monitor)
    put("exec", "n_chunks", args.n_chunks)
    put("exec", "chunk_nnz", args.chunk_nnz)
    if getattr(args, "trace_dir", None):
        base["obs"]["enabled"] = True
        base["obs"]["trace_dir"] = args.trace_dir
    if getattr(args, "trace_split", None):
        base["obs"]["enabled"] = True
        base["obs"]["routines"] = "split"
    if getattr(args, "http_port", None) is not None:
        base["obs"]["enabled"] = True
        base["obs"]["http_port"] = args.http_port
    put("obs", "heartbeat_s", getattr(args, "heartbeat_s", None))
    put("obs", "events_buffer", getattr(args, "events_buffer", None))
    put("serve", "port", getattr(args, "port", None))
    if getattr(args, "tenants", None):
        base["serve"]["tenants"] = tuple(args.tenants)
    put("serve", "workers", getattr(args, "serve_workers", None))
    put("serve", "max_wait_ms", getattr(args, "max_wait_ms", None))
    if getattr(args, "buckets", None):
        base["serve"]["buckets"] = tuple(args.buckets)
    put("serve", "max_resident_mb", getattr(args, "budget_mb", None))
    return RunConfig.from_dict(base)


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------


def _session(args):
    """The RunConfig from the flags, and a Session over it on --device."""
    from .session import Session

    cfg = config_from_args(args)
    return cfg, Session(cfg, device=args.device)


def cmd_ingest(args) -> int:
    cfg, sess = _session(args)
    t0 = time.time()
    ing = sess.ingest()
    sess.synchronize()
    dt = time.time() - t0
    print(f"# ingest: {cfg.summary()}")
    print(f"dims={ing.dims} nnz={ing.tensor.nnz:,} "
          f"reorder={cfg.data.reorder} cache_hit={ing.cache_hit} "
          f"wall={dt:.2f}s")
    for m, s in enumerate(ing.stats):
        print(f"  mode {m}: rows={s.rows} collision={s.block_collision_rate:.3f} "
              f"padding={s.padding_overhead:.3f} skew={s.skew:.3f}")
    return 0


def cmd_plan(args) -> int:
    cfg, sess = _session(args)
    print(f"# plan: {cfg.summary()}")
    print(sess.plan_report())
    return 0


def cmd_fit(args) -> int:
    cfg, sess = _session(args)
    print(f"# fit: {cfg.summary()}")
    print(sess.plan_report())
    if args.dryrun:
        print("# --dryrun: plan only, skipping execution")
        return 0
    if cfg.obs.http_port is not None:
        # bring the endpoint up (and print the resolved port) BEFORE the
        # fit blocks, so a watcher can start scraping immediately
        print(f"# live metrics at {sess.exposition().url}/metrics",
              flush=True)
    t0 = time.time()
    try:
        dec = sess.fit()
        sess.synchronize()  # the card runs asynchronously: drain it
        if args.hold_s:
            # keep the live endpoints up for scrapers that arrived late
            time.sleep(args.hold_s)
    finally:
        sess.close()
    print(f"fit={float(dec.fit):.6f} wall={time.time() - t0:.2f}s")
    if cfg.obs.trace_dir:
        print(f"# trace written to {cfg.obs.trace_dir} "
              f"(python -m repro_torch trace {cfg.obs.trace_dir})")
    if args.out:
        _save_factors(args.out, dec)
        print(f"# wrote {args.out}")
    return 0


def _save_factors(path: str, dec) -> None:
    import numpy as np

    arrays = {f"factor_{m}": f.cpu().numpy()
              for m, f in enumerate(dec.factors)}
    if hasattr(dec, "lmbda"):
        arrays["lmbda"] = dec.lmbda.cpu().numpy()
    if hasattr(dec, "core"):
        arrays["core"] = dec.core.cpu().numpy()
    arrays["fit"] = np.asarray(float(dec.fit), dtype=np.float32)
    np.savez(path, **arrays)


def cmd_serve(args) -> int:
    cfg, sess = _session(args)
    print(f"# serve: {cfg.summary()}")
    print(sess.plan_report())
    t0 = time.time()
    try:
        handle = sess.serve_handle()
        sess.synchronize()  # the card runs asynchronously: drain the fit
        t_fit = time.time() - t0
        bench = handle.benchmark(queries=args.queries, batch=args.batch,
                                 seed=cfg.method.seed)
        lat = bench["latency_ms"]
        print(f"fit={handle.fit:.4f} decompose={t_fit:.2f}s "
              f"serve={bench['serve_s']:.2f}s ({bench['qps']:,.0f} vals/s, "
              f"p50 {lat['p50']:.2f}ms p99 {lat['p99']:.2f}ms)")
        sess.export_obs()  # serve spans + latency histogram join the trace
    finally:
        sess.close()
    return 0


def cmd_serve_daemon(args) -> int:
    """Fit (or load) the configured decomposition, publish it under every
    ``serve.tenants`` id, and serve the HTTP query API until
    ``POST /v1/shutdown`` (or ``--duration-s``)."""
    from repro_torch.serve import ServeDaemon

    cfg, sess = _session(args)
    print(f"# serve-daemon: {cfg.summary()}")
    try:
        server = sess.decomp_server()  # fit + publish cfg.serve.tenants
        daemon = ServeDaemon(server, port=cfg.serve.port or 0).start()
        print(f"# serving {list(cfg.serve.tenants)} at {daemon.url}  "
              f"(GET /healthz /metrics /v1/tenants "
              f"/v1/top_k?tenant=&user=&k=; POST /v1/values_at "
              f"/v1/shutdown)", flush=True)
        try:
            daemon.serve_until_shutdown(duration_s=args.duration_s)
        finally:
            daemon.stop()
        stats = server.stats()
        print(f"# shutdown: {stats['batches_executed']} batches executed, "
              f"queue depth {stats['queue_depth']}")
    finally:
        sess.close()
    return 0


def cmd_trace(args) -> int:
    """Table-III-style per-routine breakdown of a recorded trace dir."""
    from repro_torch.obs.report import trace_report

    try:
        print(trace_report(args.dir, with_metrics=not args.no_metrics))
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


def cmd_metrics(args) -> int:
    """Render a standalone ``metrics.json`` (or a trace dir holding one)
    as the markdown metrics table."""
    from pathlib import Path

    from repro_torch.obs.report import format_metrics
    from repro_torch.obs.trace import METRICS_FILENAME

    path = Path(args.dir)
    if path.is_dir():
        path = path / METRICS_FILENAME
    if not path.exists():
        print(f"error: no {METRICS_FILENAME} at {args.dir} — record one "
              f"with `python -m repro_torch fit ... --trace-dir {args.dir}`",
              file=sys.stderr)
        return 2
    print(format_metrics(json.loads(path.read_text())))
    return 0


def cmd_dryrun(args) -> int:
    """Dry-run of one cell.  Re-execs ``repro_torch.launch.dryrun`` in a
    fresh interpreter: its fake process group of 256 or 512 ranks is
    process-global and must be the only group of its process."""
    import subprocess

    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", args.workload, "--mesh", args.mesh]
    if args.tag:
        cmd += ["--tag", args.tag]
    for ov in args.override:
        cmd += ["--override", ov]
    return subprocess.call(cmd)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="One front door over the PyTorch decomposition stack: "
                    "ingest -> plan -> fit -> serve (repro_torch.api).")
    ap.add_argument("--list-methods", action="store_true",
                    help="print the method + executor capability matrices")
    ap.add_argument("--list-impls", action="store_true",
                    help="print the kernel-impl capability matrices")
    sub = ap.add_subparsers(dest="command")

    for name, fn, extra in (
            ("ingest", cmd_ingest, ()),
            ("plan", cmd_plan, ()),
            ("fit", cmd_fit, ("dryrun", "out")),
            ("serve", cmd_serve, ("queries", "batch")),
    ):
        p = sub.add_parser(name, help=f"{name} stage of the pipeline")
        _add_config_args(p)
        _add_device_arg(p)
        if "dryrun" in extra:
            p.add_argument("--dryrun", action="store_true",
                           help="print the plan and exit without fitting")
            p.add_argument("--hold-s", type=float, default=None, metavar="S",
                           help="keep the live exposition endpoints up S "
                                "seconds after the fit completes (for "
                                "scrapers watching a short run)")
        if "out" in extra:
            p.add_argument("--out", default=None, metavar="FACTORS.npz",
                           help="save factors/lambda/fit to an .npz")
        if "queries" in extra:
            p.add_argument("--queries", type=int, default=2048)
            p.add_argument("--batch", type=int, default=256)
        p.set_defaults(fn=fn)

    p = sub.add_parser(
        "serve-daemon",
        help="fit, publish under serve.tenants, and serve the HTTP query "
             "API (repro_torch.serve.DecompServer) until POST /v1/shutdown")
    _add_config_args(p)
    _add_device_arg(p)
    p.add_argument("--duration-s", type=float, default=None, metavar="S",
                   help="exit after S seconds even without /v1/shutdown")
    p.set_defaults(fn=cmd_serve_daemon)

    p = sub.add_parser(
        "trace",
        help="print the Table-III-style per-routine breakdown of a "
             "recorded trace dir (see fit --trace-dir)")
    p.add_argument("dir", help="directory holding trace.jsonl/metrics.json")
    p.add_argument("--no-metrics", action="store_true",
                   help="skip the metrics dump, print the routine table only")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser(
        "metrics",
        help="render a recorded metrics.json as the metrics table "
             "(see fit --trace-dir)")
    p.add_argument("dir", help="directory holding metrics.json (or the "
                               "file itself)")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser(
        "dryrun",
        help="trace one cell on a fake 256/512-rank group "
             "(repro_torch.launch.dryrun)")
    p.add_argument("--workload", required=True,
                   help="cpals-<workload> or an arch id")
    p.add_argument("--mesh", choices=["single", "multi"], default="single")
    p.add_argument("--tag", default="")
    p.add_argument("--override", action="append", default=[])
    p.set_defaults(fn=cmd_dryrun)

    args = ap.parse_args(argv)
    if args.list_methods:
        print(list_methods())
        return 0
    if args.list_impls:
        print(list_impls())
        return 0
    if args.command is None:
        ap.print_help()
        return 2
    try:
        return args.fn(args)
    except (ConfigError, ValueError, OSError) as e:
        # OSError: a missing/unreadable --source or --cache path is a user
        # mistake, not a crash — same friendly exit as config errors
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
