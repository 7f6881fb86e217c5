"""Cells at a size a CPU test can run: the debug shapes of the port's
tests, the real mixes cut to a handful of short requests or rows. The
chat cell keeps its own limits; the train cell takes this size's."""

from __future__ import annotations

import copy

from benchmark.harness import spec

DEBUG = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 128,
         "vocab_size": 256, "max_position_embeddings": 4096,
         "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "hidden_act": "silu",
         "tie_word_embeddings": False}


def chat_cell() -> spec.Cell:
    cell = spec.load_cell("mistral-7b.chat")
    cell.config = dict(DEBUG)
    t = copy.deepcopy(cell.traffic)
    t["engine"].update(slots=4, capacity=512, page_tokens=16,
                       prefill_chunk_tokens=128)
    t["arrivals"]["rate_per_s"] = 4.0
    t["prompt_tokens"].update(median=60, sigma=0.8, min=8, max=300)
    t["output_tokens"].update(median=8, sigma=0.8, min=2, max=40)
    t["warmup"] = {"prompt_tokens": [20, 100, 200], "output_tokens": 2}
    t["trace_seconds"] = 1.0
    t["residents"] = {"seconds": 0.5}
    t["drain_s"] = 30
    t["check"]["served_tokens"] = 60
    cell.traffic = t
    return cell


def train_cell() -> spec.Cell:
    cell = spec.load_cell("internlm2-1.8b.train4k")
    cell.config = dict(DEBUG, vocab_size=512)
    t = copy.deepcopy(cell.traffic)
    t["batch"] = {"rows": 4, "seq_len": 64}
    t["model"]["loss_chunk"] = 16
    t["trace_seconds"] = 0.5
    cell.traffic = t
    # bf16 rounding weighs more at width 64 than at the cell's 2048: sound
    # runs here read loss gaps to 0.0017, gradient-norm gaps to 0.0043 and
    # change gaps to 0.0013; the faults read 0.09-0.14, 0.40-0.47 and
    # 0.21-0.22 (half the batch), 1 (no update), 0.12 (the loss x 1.01).
    cell.limits = {"loss_gap": 0.02, "grad_norm_gap": 0.05,
                   "change_norm_gap": 0.05}
    return cell
