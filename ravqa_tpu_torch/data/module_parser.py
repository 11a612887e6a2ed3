"""Declarative per-sample input assembly (ModuleParser).

Re-creates the reference's config-driven feature assembly
(the reference src/data_ops/custom_datasets/module_parser.py:10-530):
`model_config.input_modules / decoder_input_modules / output_modules` are
lists of module specs applied per sample; text pieces join with spaces.

Module spec fields (dict): type, option, separation_tokens {start, sep, end},
plus module-specific knobs (attribute_max/attribute_thres/ocr for
TextBasedVisionInput object mode; prompts for InstructionInput).

The port's own copy of ravqa_tpu/data/module_parser.py (host-only code).
"""

from __future__ import annotations

import random
from typing import Any, Optional

import numpy as np


def _st(module: dict) -> dict:
    st = module.get("separation_tokens", {})
    return {"start": st.get("start", ""), "sep": st.get("sep", ""),
            "end": st.get("end", "")}


class ModuleParser:
    """parse(sample, modules) -> dict(text_sequence, vision_features, ...)."""

    # -- text input modules ---------------------------------------------------
    def QuestionInput(self, sample: dict, module: dict) -> dict:
        st = _st(module)
        return {"text_sequence": " ".join(
            [st["start"], sample["question"], st["end"]]).strip()}

    def InstructionInput(self, sample: dict, module: dict) -> dict:
        st = _st(module)
        if sample.get("question") is not None:
            body = sample["question"]
        else:
            body = random.choice(module["prompts"])
        return {"text_sequence": " ".join(
            [st["start"], body, st["end"]]).strip()}

    def EmptyTextInput(self, sample: dict, module: dict) -> dict:
        return {"text_sequence": ""}

    def TextBasedVisionInput(self, sample: dict, module: dict) -> dict:
        st = _st(module)
        option = module.get("option", "caption")
        if option == "object":
            pieces = [st["start"]]
            for obj in sample.get("objects", []):
                amax = module.get("attribute_max", 0)
                if amax > 0:
                    kept = []
                    for att, score in zip(obj.get("attributes", []),
                                          obj.get("attribute_scores", [])):
                        if score > module.get("attribute_thres", 0.0) \
                                and len(kept) < amax:
                            kept.append(att)
                    pieces += kept
                pieces.append(obj["class"])
                pieces.append(st["sep"])
            if module.get("ocr", 0) > 0:
                seen = []
                for t in sample.get("img_ocr", []):
                    desc = t["description"].strip().replace("\n", " ")
                    if desc not in seen:
                        seen.append(desc)
                pieces += seen
            pieces.append(st["end"])
            return {"text_sequence": " ".join(p for p in pieces if p)}
        if option == "caption":
            cap = sample.get("img_caption", "")
            if isinstance(cap, dict):
                cap = cap.get("caption", "")
            return {"text_sequence": " ".join(
                [st["start"], cap, st["end"]]).strip()}
        raise ValueError(option)

    def KnowledgeInput(self, sample: dict, module: dict) -> dict:
        st = _st(module)
        return {"text_sequence": " ".join(
            [st["start"], sample["passage_content"], st["end"]]).strip()}

    # -- vision input modules -------------------------------------------------
    def VisionInput(self, sample: dict, module: dict) -> dict:
        option = module.get("option", "from_embeddings")
        if option == "from_embeddings":
            feats = sample["image_features"]
            num_rois = module.get("num_ROIs", 0)
            if module.get("use_ROI", False) and num_rois:
                # Reference ROI stacking & padding (module_parser.py:154-178):
                # row 0 is the global image feature; ROI rows pad by
                # repeating the LAST ROI up to num_ROIs, then truncate ->
                # fixed (1 + num_ROIs, dim). With zero ROIs the global
                # feature repeats (the reference would IndexError there).
                feats = np.asarray(feats)
                if feats.ndim == 1:
                    feats = feats[None]
                glob, rois = feats[:1], list(feats[1:])
                pad = rois[-1] if rois else glob[0]
                rois = (rois + [pad] * (num_rois - len(rois)))[:num_rois]
                feats = np.concatenate([glob, np.stack(rois)]) if rois \
                    else glob
            return {"vision_features": feats}
        if option == "from_file":
            return {"pixel_values": sample["image"]}
        raise ValueError(option)

    # -- output modules -------------------------------------------------------
    def GenerationOutput(self, sample: dict, module: dict) -> dict:
        return {"text_sequence": sample["gold_answer"]}

    def SimilarityOutput(self, sample: dict, module: dict) -> dict:
        return {"pos_item_ids": sample.get("pos_item_ids", []),
                "neg_item_ids": sample.get("neg_item_ids", [])}

    # -- dispatch -------------------------------------------------------------
    def parse(self, sample: dict, modules: list[dict]) -> dict:
        out: dict[str, Any] = {"text_sequence": ""}
        texts = []
        for module in modules:
            fn = getattr(self, module["type"])
            r = fn(sample, module)
            t = r.pop("text_sequence", None)
            if t:
                texts.append(t)
            out.update(r)
        out["text_sequence"] = " ".join(texts)
        return out
