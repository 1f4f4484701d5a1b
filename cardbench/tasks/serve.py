"""Serving cells: ``Estimator.predict_decoded`` (greedy) or
``predict_beam_decoded`` (beam) over all 38 outputs, on the traffic's packed
requests, in a closed loop that keeps one request launched ahead of the one
whose decoded grid (or n-best) it copies back, as ``allophant predict`` does.

Set-up builds the model, draws its weights, makes the traffic's requests
(``replay_cycles`` cycles of them, offered again and again) and runs one
request at each padded width the traffic can produce. The window launches
requests until
``--seconds`` have passed and drains the last; every request of the window
counts in the tail. Afterwards a sample of the finished requests drawn from
the seed, the longest among them, is held to the plain reference.

A closed loop keeps the card at capacity, so its end-to-end metric is the
rate; the 95th percentile of every request's latency is a per-layer reading
(``request_p95_ms.serve``)."""

from __future__ import annotations

import contextlib
import gc
import math
import time
from collections import deque
from typing import Dict, List, Tuple

import numpy as np
import torch

from cardbench.core import card, port, registry
from cardbench.core.context import Check, Context, Result
from cardbench.core.trace import ModuleSpans, Trace, kernel_seconds
from cardbench.core import weights as weights_module
from cardbench.reference import beam as reference_beam
from cardbench.reference import judge
from cardbench.reference.model import Numerics, ReferenceAllophant, serving_heads
from cardbench.reference.numerics import full_float32


class Server:
    """The timed call and its copy back, with the fault hooks of the tests."""

    def __init__(self, context: Context, estimator, heads: List[str]):
        from allophant_tpu_torch.data.batch import Batch

        self.batch_type = Batch
        self.estimator = estimator
        self.heads = tuple(heads)
        decode = context.traffic["decode"]
        self.beam_width = int(decode["beam_width"]) if decode["kind"] == "beam" else None
        self.faults = context.faults

    def launch(self, request):
        batch = self.batch_type(request.audio, request.lengths, request.language_ids)
        if self.beam_width is None:
            return self.estimator.predict_decoded(batch, heads=self.heads)
        return self.estimator.predict_beam_decoded(batch, heads=self.heads, beam_width=self.beam_width)

    def fetch(self, launched) -> Tuple[np.ndarray, ...]:
        if self.beam_width is None:
            grid, _lengths = launched
            host = (grid.cpu().numpy(),)
        else:
            collected, scores, lengths = launched
            host = (collected.cpu().numpy(), scores.cpu().numpy(), lengths.cpu().numpy())
        if "served" in self.faults:
            host = self.faults["served"](host)
        return host

    def padded_frames(self, host) -> int:
        """The frames a request's bucket ran, off the output's time axis."""
        return host[0].shape[2] - 1 if self.beam_width is None else host[0].shape[1]


class Sample:
    """The finished requests kept for the check: the longest, and a seeded
    uniform sample of the others (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size = max(1, size)
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 0xC4EC])
        self.longest = None
        self.others: List = []
        self.seen = 0

    def offer(self, request, host) -> None:
        key = (request.audio.shape[1], request.real_samples)
        if self.longest is None or key > (self.longest[0].audio.shape[1], self.longest[0].real_samples):
            if self.longest is not None:
                self._reservoir(self.longest)
            self.longest = (request, host)
            return
        self._reservoir((request, host))

    def _reservoir(self, item) -> None:
        self.seen += 1
        if len(self.others) < self.size - 1:
            self.others.append(item)
            return
        slot = int(self.rng.integers(0, self.seen))
        if slot < self.size - 1:
            self.others[slot] = item

    def items(self):
        return ([self.longest] if self.longest is not None else []) + self.others


def _closed_loop(server: Server, stream, stop, on_done, ahead: int = 1):
    """Launches requests while ``stop()`` is false, ``ahead`` of the one it
    copies back; returns (launched, failed)."""
    pending: deque = deque()
    launched = failed = 0
    while True:
        while not stop() and len(pending) <= ahead:
            request = next(stream)
            started = time.perf_counter()
            launched += 1
            try:
                pending.append((request, started, server.launch(request)))
            except Exception as error:  # noqa: BLE001 - a failed request counts, the run goes on
                failed += 1
                print(f"cardbench: request {request.index} failed at launch: {error!r}", flush=True)
        if not pending:
            return launched, failed
        request, started, output = pending.popleft()
        try:
            host = server.fetch(output)
        except Exception as error:  # noqa: BLE001
            failed += 1
            print(f"cardbench: request {request.index} failed: {error!r}", flush=True)
            continue
        on_done(request, started, time.perf_counter(), host)


def run(context: Context) -> Result:
    from allophant_tpu_torch.training.estimator import Estimator

    config, traffic, head = context.config, context.traffic, context.head
    device = torch.device(context.device)
    on_card = device.type == "cuda"
    kind = registry.traffic_kind(traffic["kind"])
    model, _ = port.build(config, head, context.seed, device, training=False)
    estimator = Estimator(model, config["precision"], device)
    context.log(f"model built, weights loaded: {time.perf_counter() - context.started:.3f} s")
    heads = serving_heads(head["plan"])
    server = Server(context, estimator, heads)
    layers = config["architecture"]["num_hidden_layers"]
    groups = len({node["output_size"] for node in head["plan"]["nodes"]})

    stream = kind.replayed(traffic, context.seed)
    for request in kind.warmup_requests(traffic, context.seed):
        server.fetch(server.launch(request))
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - context.started
    context.log(f"set-up {setup_s:.3f} s")

    latencies: List[float] = []
    totals = {"real_samples": 0, "real_frames": 0, "padded_frames": 0, "requests": 0}
    lengths_done: List[int] = []
    sample = Sample(int(traffic["check"]["requests"]), context.seed)

    def done(request, started, finished, host):
        latencies.append(finished - started)
        totals["real_samples"] += request.real_samples
        totals["real_frames"] += int(port.frame_lengths(config, request.lengths).clip(min=0).sum())
        totals["padded_frames"] += len(request.lengths) * server.padded_frames(host)
        totals["requests"] += 1
        lengths_done.extend(int(value) for value in request.lengths)
        sample.offer(request, host)

    before = card.counters()
    start = time.perf_counter()
    deadline = start + context.seconds
    with card.TwinsForbidden() if on_card else contextlib.nullcontext():
        launched, failed = _closed_loop(server, stream, lambda: time.perf_counter() >= deadline, done, traffic["loop"]["ahead"])
    wall = time.perf_counter() - start
    launches = card.counted_since(before)
    departures = port.precision_departures(config)
    if departures:
        context.log(f"precision departs from the configuration: {departures}")

    audio_s = totals["real_samples"] / traffic["sample_rate"]
    end_to_end = {"setup_s": setup_s, "serve_audio_s_per_s": audio_s / wall}
    p95_ms = float(np.percentile(np.asarray(latencies) * 1e3, 95)) if latencies else math.inf
    from cardbench.work import model_flops

    parts = config["precision_parts"]
    flops = model_flops.total_flops(
        config, head["plan"], lengths_done, parts["encoder"],
        "tf32" if parts["float32_matmul"] == "high" else "float32", training=False,
    )
    readings: Dict = {
        "window": {"wall_s": wall, "audio_s": audio_s, "flops": flops, "p95_ms": p95_ms, **totals},
        "config": config,
    }

    finished = totals["requests"]
    per_request = registry.encoder(config["encoder"]).serve_launches(config["architecture"])
    expected = {name: count * finished for name, count in per_request.items()}
    if server.beam_width is not None:
        expected["K3"] = expected["backtrace"] = groups * finished
    launch_gap = card.launch_gap(launches, expected) if on_card else 0
    print("cardbench launches: " + ", ".join(f"{name} {launches[name]} (expected {expected.get(name, 0)})" for name in launches), flush=True)

    busy_s = window_s = breakdown = None
    if context.trace:
        busy_s, window_s, breakdown, readings["trace"] = _traced_stretch(context, server, stream, model, layers)

    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kept = sample.items()
    del server, estimator, model, stream
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    check_start = time.perf_counter()
    numbers = _judge(context, kept, heads, Numerics())
    context.log(f"reference check {time.perf_counter() - check_start:.3f} s over {len(kept)} requests")
    checks = {
        **{name: Check(value, context.limits[name]) for name, value in numbers.items()},
        "requests_failed": Check(float(failed), 0.0),
        "kernel_launches_off": Check(float(launch_gap), 0.0),
        "precision_off": Check(float(len(departures)), 0.0),
    }
    return Result(end_to_end, readings, launched, failed, checks, int(memory_peak), busy_s, window_s, breakdown)


def _traced_stretch(context: Context, server: Server, stream, model, layers: int):
    """Profiles the next ``trace_requests`` requests of the window's stream
    with the benchmark's spans and reads device time, idle share, rooflines
    and the breakdown."""
    from torch.profiler import ProfilerActivity, profile, record_function

    traffic = context.traffic
    count = int(traffic["trace_requests"])
    spans = [ModuleSpans(model.acoustic_model, "cardbench.encoder"), ModuleSpans(model.projection, "cardbench.head")]
    shapes = []
    launched = [0]

    class Spanned:
        def launch(self, request):
            launched[0] += 1
            with record_function("cardbench.request"):
                return server.launch(request)

        fetch = staticmethod(server.fetch)

    def done(request, _started, _finished, host):
        shapes.append({
            "rows": len(request.lengths),
            "padded_frames": server.padded_frames(host),
            "frames": [int(value) for value in port.frame_lengths(context.config, request.lengths)],
            "audio_s": request.real_samples / traffic["sample_rate"],
        })

    def stop():
        return launched[0] >= count

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    try:
        with profile(activities=activities) as profiler:
            with record_function("cardbench.stretch"):
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                _closed_loop(Spanned(), stream, stop, done, traffic["loop"]["ahead"])
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    finally:
        for span in spans:
            span.remove()
    path = context.trace_path()
    profiler.export_chrome_trace(str(path))
    trace = Trace.read(path)
    path.unlink()
    start, end = trace.window("cardbench.stretch")
    busy = trace.busy_us(start, end)
    requests = trace.ranges.get("cardbench.request", [])
    encoder = trace.ranges.get("cardbench.encoder", [])
    head = trace.ranges.get("cardbench.head", [])
    after_head = []
    for low, high in requests:
        ends = [span_end for span_start, span_end in head if low <= span_start <= high]
        if ends:
            after_head.append((max(ends), high))
    kernel_s = kernel_seconds(trace)
    context.log(f"device seconds by kernel in the traced stretch: {kernel_s}")
    readings = {
        "wall_s": (end - start) * 1e-6,
        "busy_s": busy * 1e-6,
        "audio_s": sum(shape["audio_s"] for shape in shapes),
        "requests": shapes,
        "layers": layers,
        "encoder_s": trace.device_us(trace.launched_in(encoder)) * 1e-6,
        "head_s": trace.device_us(trace.launched_in(head)) * 1e-6,
        "decode_s": trace.device_us(trace.launched_in(after_head)) * 1e-6,
        "kernel_s": kernel_s,
        "k1_s": kernel_s["K1"],
        "k3_s": kernel_s["K3"],
        "beam_width": server.beam_width,
        "heads_by_classes": _heads_by_classes(context.head["plan"]),
    }
    return busy * 1e-6, (end - start) * 1e-6, trace.breakdown(start, end), readings


def _heads_by_classes(plan: dict) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    for node in plan["nodes"]:
        counts[node["output_size"]] = counts.get(node["output_size"], 0) + 1
    phone = next(node["output_size"] for node in plan["nodes"] if node.get("has_composition"))
    counts[phone] += 1  # the phone layer is served as both phone and phoneme
    return counts


def reference_log_probs(context: Context, model: ReferenceAllophant, request, numerics: Numerics):
    """(log-probs by output [B, T, C] float32, frame lengths [B]) of the
    reference over one request's rows."""
    device = next(model.parameters()).device
    audio = torch.as_tensor(request.audio[:, : int(request.lengths.max())], device=device)
    lengths = torch.as_tensor(request.lengths, dtype=torch.long, device=device)
    languages = torch.as_tensor(request.language_ids, dtype=torch.long, device=device)
    with torch.no_grad(), full_float32():
        outputs, frames = model(audio, lengths, languages, numerics)
        return {name: torch.log_softmax(value, dim=-1) for name, value in outputs.items()}, frames


def build_reference(context: Context, device) -> ReferenceAllophant:
    config, head = context.config, context.head
    model = ReferenceAllophant(config, head, device=device)
    drawn = weights_module.draw(model.shapes(), context.seed, device, head["static"])
    weights_module.load_into(model, drawn)
    return model.eval()


def served_best(context: Context, host, heads: List[str]) -> Dict[str, tuple]:
    """Each output's served best sequence of every row, and for beam search
    its score: {name: (sequences, scores or None)}."""
    out = {}
    if context.traffic["decode"]["kind"] == "greedy":
        grid = host[0].astype(np.int64)
        for index, name in enumerate(heads):
            out[name] = ([grid[index, row, 1 : 1 + grid[index, row, 0]] for row in range(grid.shape[1])], None)
    else:
        collected, scores = host[0].astype(np.int64), host[1]
        for index, name in enumerate(heads):
            out[name] = (judge.beam_top_sequences(collected[index], scores[index]), scores[index].max(axis=1))
    return out


def reference_best(context: Context, log_probs: Dict[str, torch.Tensor], frames: torch.Tensor, heads: List[str]) -> Dict[str, tuple]:
    """The same from the reference's own decode of ``log_probs``: greedy, or
    the frozen beam search over the heads of each class count stacked along
    the rows, as the port stacks them."""
    decode = context.traffic["decode"]
    if decode["kind"] == "greedy":
        return {name: (judge.greedy_sequences(log_probs[name], frames), None) for name in heads}
    width = int(decode["beam_width"])
    groups: Dict[int, List[str]] = {}
    for name in heads:
        groups.setdefault(log_probs[name].shape[-1], []).append(name)
    out = {}
    rows = frames.shape[0]
    for members in groups.values():
        stacked = torch.cat([log_probs[name] for name in members])
        lengths = frames.repeat(len(members))
        parents, emitted, scores = reference_beam.beam_search_padded(stacked, lengths, width, 0)
        collected = reference_beam.backtrace_beams_device(parents, emitted, lengths).cpu().numpy()
        scores = scores.cpu().numpy()
        for index, name in enumerate(members):
            part = slice(index * rows, (index + 1) * rows)
            out[name] = (judge.beam_top_sequences(collected[:, part], scores[part]), scores[part].max(axis=1))
    return out


def decode_gap(context: Context, log_probs, frames, best: Dict[str, tuple], heads: List[str]) -> float:
    """The widest gap of decoded ``best`` under the reference's ``log_probs``.
    Greedy: the bottleneck gap of each sequence. Beam: each best hypothesis's
    score less the reference's CTC log-likelihood of that hypothesis (a beam
    score sums the alignments the search kept, so it cannot pass the
    hypothesis's likelihood under the log-probabilities it searched)."""
    worst = -math.inf
    for name in heads:
        sequences, scores = best[name]
        if scores is None:
            tokens, counts = judge.pad_sequences(sequences, frames.device)
            gaps = judge.bottleneck_gaps(log_probs[name], frames, tokens, counts)
        else:
            likelihoods = judge.ctc_log_likelihoods(log_probs[name], frames, sequences)
            gaps = torch.as_tensor(scores, dtype=torch.float64, device=likelihoods.device) - likelihoods
            gaps = torch.where(torch.isnan(gaps), torch.full_like(gaps, math.inf), gaps)
        worst = max(worst, float(gaps.max()))
    return worst


def beam_shortfalls(context: Context, log_probs, frames, best: Dict[str, tuple], heads: List[str]) -> Dict[int, List[float]]:
    """How far each best score of ``best`` falls below the best score of the
    reference's own beam search over ``log_probs`` on the same row, by class
    count (one K3 launch each); infinite where the score is not finite."""
    reference = reference_best(context, log_probs, frames, heads)
    out: Dict[int, List[float]] = {}
    for name in heads:
        served = np.asarray(best[name][1], dtype=np.float64)
        ours = np.asarray(reference[name][1], dtype=np.float64)
        shortfalls = np.where(np.isfinite(served), ours - served, math.inf)
        out.setdefault(int(log_probs[name].shape[-1]), []).extend(shortfalls.tolist())
    return out


class Tally:
    """The numbers a serving check compares, gathered request by request:
    ``greedy_gap_nats``, or ``beam_gap_nats`` and ``beam_shortfall_nats``
    (the largest mean shortfall of a class count, over every row and output
    of that count in the sample)."""

    def __init__(self, context: Context, heads: List[str]):
        self.context, self.heads = context, heads
        self.beam = context.traffic["decode"]["kind"] == "beam"
        self.gap = -math.inf
        self.shortfalls: Dict[int, List[float]] = {}

    def add(self, log_probs, frames, best: Dict[str, tuple]) -> None:
        self.gap = max(self.gap, decode_gap(self.context, log_probs, frames, best, self.heads))
        if self.beam:
            for classes, values in beam_shortfalls(self.context, log_probs, frames, best, self.heads).items():
                self.shortfalls.setdefault(classes, []).extend(values)

    def numbers(self) -> Dict[str, float]:
        if not self.beam:
            return {"greedy_gap_nats": self.gap}
        means = [float(np.mean(values)) for values in self.shortfalls.values()]
        return {"beam_gap_nats": self.gap, "beam_shortfall_nats": max(means) if means else math.inf}


def _judge(context: Context, kept, heads: List[str], numerics: Numerics) -> Dict[str, float]:
    tally = Tally(context, heads)
    if not kept:
        return {name: math.inf for name in tally.numbers()}
    device = torch.device(context.device)
    model = build_reference(context, device)
    for request, host in kept:
        log_probs, frames = reference_log_probs(context, model, request, numerics)
        tally.add(log_probs, frames, served_best(context, host, heads))
    del model
    return tally.numbers()


def control_numbers(context: Context, requests, control: Numerics) -> Dict[str, float]:
    """The same numbers for the control: the reference computed at a lower
    precision, in the program's place, decoding the same requests."""
    device = torch.device(context.device)
    model = build_reference(context, device)
    heads = serving_heads(context.head["plan"])
    tally = Tally(context, heads)
    for request in requests:
        exact, frames = reference_log_probs(context, model, request, Numerics())
        lowered, _ = reference_log_probs(context, model, request, control)
        tally.add(exact, frames, reference_best(context, lowered, frames, heads))
    return tally.numbers()
