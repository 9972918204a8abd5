"""VLM part-reasoning client: object classification + ranked part names.

The port's copy of fusionsense_tpu/touch_select/vlm.py (no torch).

Behavioral spec from the reference's VLM script (reference
scripts/VLM.py:48-53, 314-370): send a scene image to a vision-language
model with a structured-output schema {classification: str, parts:
[str, ...]} (ranked most- to least-informative-to-touch), temperature 0.

Implementation: a provider-agnostic HTTP client for any OpenAI-compatible
chat-completions endpoint (the reference hardcodes gpt-4o). Zero-egress
environments use `StaticPartProvider` (fixture responses) — the rest of the
Active Touch Selection pipeline is exercised without network access.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import urllib.request
from pathlib import Path
from typing import Protocol


@dataclasses.dataclass
class PartResponse:
    classification: str
    parts: list[str]          # ranked, most informative to touch first


class PartProvider(Protocol):
    def part_names(self, image_path: str | Path) -> PartResponse: ...


PART_PROMPT = (
    "You are assisting a robot that reconstructs objects by touch. "
    "Classify the main object in the image, then list its distinct parts "
    "ranked by how informative touching each part would be for 3D "
    "reconstruction (prefer geometrically complex, concave, or reflective "
    "regions that cameras capture poorly). Respond as JSON: "
    '{"classification": "<object>", "parts": ["<part1>", "<part2>", ...]}'
)


@dataclasses.dataclass
class OpenAICompatProvider:
    """Client for any OpenAI-compatible /chat/completions endpoint."""

    api_key: str
    model: str = "gpt-4o"
    base_url: str = "https://api.openai.com/v1"
    temperature: float = 0.0

    def part_names(self, image_path: str | Path) -> PartResponse:
        with open(image_path, "rb") as f:
            b64 = base64.b64encode(f.read()).decode()
        body = {
            "model": self.model,
            "temperature": self.temperature,
            "response_format": {"type": "json_object"},
            "messages": [{
                "role": "user",
                "content": [
                    {"type": "text", "text": PART_PROMPT},
                    {"type": "image_url",
                     "image_url": {"url": f"data:image/png;base64,{b64}"}},
                ],
            }],
        }
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"},
        )
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.load(resp)
        content = out["choices"][0]["message"]["content"]
        parsed = json.loads(content)
        return PartResponse(classification=parsed["classification"],
                            parts=list(parsed["parts"]))


@dataclasses.dataclass
class StaticPartProvider:
    """Offline fixture provider (no network). Used in tests and air-gapped
    runs; mirrors the shape of the VLM response exactly."""

    classification: str = "object"
    parts: tuple = ("handle", "body", "base")

    def part_names(self, image_path=None) -> PartResponse:
        return PartResponse(classification=self.classification,
                            parts=list(self.parts))
