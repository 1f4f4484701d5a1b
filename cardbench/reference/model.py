"""Plain PyTorch reference of the benchmark's models: the encoder that the
configuration names (``"encoder"``; its reference is
``reference/encoders/<encoder>.py``) under allophant's hierarchical head
(Glocker et al. 2023: one linear CTC classifier per articulatory attribute,
a phoneme layer of attribute-embedding composition and the allophone
layer's max over each phoneme's allophones).

Everything is float32 with TF32 off unless ``Numerics`` asks for a lower
precision (the control). The parameters carry the names of the benchmark's
weights. A departure from the published description, shared with the
program by construction of the benchmark's weights: the head's tables
(composition features, allophone gathers) are the frozen demo head's, not
Allophoible's. Nothing here imports the program."""

from __future__ import annotations

import importlib
import math
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cardbench.reference.layers import NEG_INF, Linear, Sites
from cardbench.reference.numerics import round_operand


@dataclass(frozen=True)
class Numerics:
    """Operand rounding of the encoder's and the head's products."""

    encoder: str = "float32"
    head: str = "float32"


def check_architecture(name: str, encoder: ModuleType, arch: dict) -> None:
    """Raises unless the reference encoder ``name`` reads every key of
    ``arch`` (``KEYS``, ``FIXED``) and implements each ``FIXED`` key's value."""
    unknown = sorted(set(arch) - set(encoder.KEYS) - set(encoder.FIXED))
    if unknown:
        raise KeyError(f"the reference encoder {name!r} reads no architecture key {unknown}")
    departed = {key: arch[key] for key, value in encoder.FIXED.items() if key in arch and arch[key] != value}
    if departed:
        raise ValueError(f"the reference encoder {name!r} implements only {encoder.FIXED}, not {departed}")


class _Composition(nn.Module):
    def __init__(self, count: int, size: int, device=None):
        super().__init__()
        self.attribute_embeddings = nn.Parameter(torch.empty(count, size, device=device))


class _Allophone(nn.Module):
    def __init__(self, shape, device=None):
        super().__init__()
        self.allophone_matrices = nn.Parameter(torch.empty(shape, device=device))


class _Head(nn.Module):
    def __init__(self, hidden: int, plan: dict, device=None):
        super().__init__()
        self.classifiers = nn.ModuleDict(
            {node["name"]: Linear(hidden, node["projection_size"], device) for node in plan["nodes"]}
        )
        size, count = plan["composition"][0], plan["composition"][1]
        self.composition = _Composition(count, size, device)
        languages, shared, phonemes, _gathers = plan["allophone_shape"]
        self.allophone = _Allophone((languages, shared, phonemes), device)


class ReferenceAllophant(nn.Module):
    """The whole model: ``forward(audio, lengths, language_ids)`` gives the
    head's logits by name, batch-first [B, T, C], and the frame lengths. The
    encoder, ``acoustic_model``, is the configuration's ``AcousticModel``."""

    def __init__(self, config: dict, head: dict, device=None):
        super().__init__()
        arch = config["architecture"]
        encoder = importlib.import_module(f"cardbench.reference.encoders.{config['encoder']}")
        check_architecture(config["encoder"], encoder, arch)
        self.plan = head["plan"]
        self.training_config = config["training"]
        self.acoustic_model = encoder.AcousticModel(arch, device)
        self.projection = _Head(arch["hidden_size"], self.plan, device)
        static = head["static"]
        table = torch.as_tensor(static["composition_feature_table"].astype(np.int64), device=device)
        offsets = torch.as_tensor(np.asarray(self.plan["composition"][2], dtype=np.int64), device=device)
        self.register_buffer("composition_indices", table + offsets[None, :], persistent=False)
        gather = torch.as_tensor(static["allophone_gather"].astype(np.int64), device=device)
        self.register_buffer("allophone_gather", gather, persistent=False)
        start = torch.as_tensor(static["allophone_matrices"], device=device)
        self.register_buffer("allophone_initialization", start, persistent=False)
        self.attribute_names = [node["name"] for node in self.plan["nodes"] if not node.get("has_composition")]
        self.phoneme_name = next(node["name"] for node in self.plan["nodes"] if node.get("has_composition"))

    def shapes(self):
        return [(name, tuple(parameter.shape)) for name, parameter in self.named_parameters()]

    def frame_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return self.acoustic_model.frame_lengths(lengths)

    def head_logits(self, hidden: torch.Tensor, kind: str, sites: Optional[Sites]) -> Dict[str, torch.Tensor]:
        """Logits of every classifier; the phoneme classifier's are the
        composed phone logits [B, T, P + 1]."""
        if sites is not None:
            batch, time, width = hidden.shape
            hidden = hidden * sites.keep(width, self.training_config["acoustic_model_dropout"], sites.head_dtype, batch, time)
        head = self.projection
        outputs = {name: head.classifiers[name](hidden, kind) for name in self.attribute_names}
        projected = head.classifiers[self.phoneme_name](hidden, kind)
        embeddings = head.composition.attribute_embeddings
        composed = torch.cat((embeddings[:1], embeddings[self.composition_indices].sum(dim=1)), dim=0)
        size = embeddings.shape[1]
        logits = F.linear(round_operand(projected, kind), round_operand(composed, kind)) * (1.0 / math.sqrt(size))
        outputs[self.phoneme_name] = logits
        return outputs

    def map_allophones(self, phone_logits: torch.Tensor, language_ids: torch.Tensor) -> torch.Tensor:
        """Each phoneme's logit: the largest of its allophones' phone logits
        times their weights in the language's allophone matrix."""
        gather = self.allophone_gather[language_ids]  # [B, P, K]
        valid = gather >= 0
        safe = gather.clamp_min(0)
        batch, phonemes, width = safe.shape
        time = phone_logits.shape[1]
        gathered = torch.gather(
            phone_logits, 2, safe.reshape(batch, 1, phonemes * width).expand(batch, time, phonemes * width)
        ).reshape(batch, time, phonemes, width)
        matrices = self.projection.allophone.allophone_matrices[language_ids].transpose(1, 2)  # [B, P, S]
        weights = torch.gather(matrices, 2, safe)
        return (gathered * weights[:, None]).masked_fill(~valid[:, None], NEG_INF).amax(dim=-1)

    def l2_penalty(self) -> torch.Tensor:
        difference = self.projection.allophone.allophone_matrices - self.allophone_initialization
        squared = difference.square().sum(dim=(1, 2))
        positive = squared > 0
        return torch.where(positive, torch.where(positive, squared, torch.ones_like(squared)).sqrt(), 0.0).sum()

    def forward(
        self,
        audio: torch.Tensor,
        lengths: torch.Tensor,
        language_ids: torch.Tensor,
        numerics: Numerics = Numerics(),
        sites: Optional[Sites] = None,
        serve: bool = True,
    ):
        """(outputs by name [B, T, C], frame lengths [B]). Serving gives the
        38 outputs (the phone layer as both ``phone`` and ``phoneme``);
        training the 37 CTC heads, the phoneme head through the allophone
        layer. The extractor runs without gradients (frozen)."""
        with torch.no_grad():
            features = self.acoustic_model.extract(audio, lengths, numerics.encoder)
        frames = self.frame_lengths(lengths)
        hidden = self.acoustic_model.encode(features, frames, numerics.encoder, sites)
        outputs = self.head_logits(hidden, numerics.head, sites)
        if serve:
            outputs["phone"] = outputs[self.phoneme_name]
        else:
            outputs[self.phoneme_name] = self.map_allophones(outputs[self.phoneme_name], language_ids)
        return outputs, frames


def serving_heads(plan: dict) -> List[str]:
    """The 38 outputs a serving request decodes, in the order the benchmark
    asks for them: the classifiers in plan order, then the phone layer."""
    return [node["name"] for node in plan["nodes"]] + ["phone"]
