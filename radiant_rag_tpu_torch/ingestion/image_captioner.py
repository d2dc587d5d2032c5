"""Image captioning for multimodal ingestion.

The port's counterpart of `radiant_rag_tpu/ingestion/image_captioner.py`,
with its names and behaviour: a metadata captioner (the file name and,
with PIL, the size and format) and a local VLM captioner over a
`transformers` checkpoint directory; `create_captioner` takes the VLM when
given a checkpoint directory and the metadata captioner without one.

The VLM runs on the card unless the caller passes device="cpu". The
device is resolved before the load: a missing card raises, and only a
failure to load the checkpoint itself turns `create_captioner` to the
metadata captioner (with a warning), as in the JAX package.
"""

from __future__ import annotations

import abc
import logging
from pathlib import Path

from radiant_rag_tpu_torch import resolve_device

logger = logging.getLogger(__name__)

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".gif", ".webp", ".bmp", ".tiff"}


class BaseCaptioner(abc.ABC):
    @abc.abstractmethod
    def caption(self, image_path: str) -> str:
        ...


class MetadataCaptioner(BaseCaptioner):
    """Deterministic captions from the file name and basic properties."""

    def caption(self, image_path: str) -> str:
        p = Path(image_path)
        name = p.stem.replace("_", " ").replace("-", " ")
        details = [f"Image: {name}"]
        try:
            from PIL import Image

            with Image.open(p) as img:
                details.append(f"{img.width}x{img.height} {img.format}")
        except Exception:  # no PIL, or not an image: the name alone
            pass
        return ". ".join(details)


def _pil_image_processor(model_dir: str):
    """The checkpoint's image processor in its PIL form, as transformers 4
    loads it (`use_fast=False`). transformers 5 calls that form
    `<Type>Pil` and loads the torchvision one by default, which raises
    without torchvision: take the PIL class by the saved type's name."""
    import json

    import transformers
    from transformers import AutoImageProcessor

    saved = Path(model_dir) / "preprocessor_config.json"
    kind = json.loads(saved.read_text()).get("image_processor_type", "") if saved.is_file() else ""
    base = kind.removesuffix("Fast").removesuffix("Pil")
    pil = getattr(transformers, f"{base}Pil", None) if base else None
    if pil is not None:
        return pil.from_pretrained(model_dir, local_files_only=True)
    return AutoImageProcessor.from_pretrained(model_dir, local_files_only=True, use_fast=False)


class HuggingFaceVLMCaptioner(BaseCaptioner):
    """A local VLM captioner from a checkpoint directory: instruction VLMs
    whose AutoProcessor takes images and text, and caption-only
    encoder-decoders (VisionEncoderDecoder class) whose image processor
    takes images only and whose output decodes through the tokenizer."""

    def __init__(self, model_dir: str, max_new_tokens: int = 128, device=None) -> None:
        self.device = resolve_device(device)
        import transformers
        from transformers import AutoTokenizer

        # AutoModelForVision2Seq as in the JAX package; transformers 5
        # serves the same models as AutoModelForImageTextToText
        auto = (getattr(transformers, "AutoModelForVision2Seq", None)
                or transformers.AutoModelForImageTextToText)
        self.model = auto.from_pretrained(model_dir, local_files_only=True).to(self.device).eval()
        try:
            from transformers import AutoProcessor

            self.processor = AutoProcessor.from_pretrained(model_dir, local_files_only=True)
        except Exception:  # no processor config: the caption-only family
            self.processor = None
        if self.processor is None or not hasattr(self.processor, "image_processor"):
            self.image_processor = _pil_image_processor(model_dir)
            self.tokenizer = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
        else:
            self.image_processor = None
            self.tokenizer = getattr(self.processor, "tokenizer", None)
        self.max_new_tokens = max_new_tokens

    def caption(self, image_path: str) -> str:
        import torch
        from PIL import Image

        image = Image.open(image_path).convert("RGB")
        if self.image_processor is not None:
            inputs = self.image_processor(images=image, return_tensors="pt")
        else:
            try:
                inputs = self.processor(images=image, text="Describe this image.",
                                        return_tensors="pt")
            except TypeError:  # a processor without a text argument
                inputs = self.processor(images=image, return_tensors="pt")
        inputs = {k: v.to(self.device) for k, v in inputs.items()}
        # never generate past the decoder's positions (small caption models
        # fail with an embedding IndexError otherwise)
        dec_cfg = getattr(self.model.config, "decoder", self.model.config)
        cap = (getattr(dec_cfg, "n_positions", None)
               or getattr(dec_cfg, "max_position_embeddings", None))
        new_tokens = self.max_new_tokens if not cap else min(self.max_new_tokens, cap - 2)
        with torch.no_grad():
            out = self.model.generate(**inputs, max_new_tokens=new_tokens)
        decoder = (self.processor.batch_decode if self.processor is not None
                   and hasattr(self.processor, "batch_decode")
                   else self.tokenizer.batch_decode)
        return decoder(out, skip_special_tokens=True)[0].strip()


def create_captioner(model_dir: str = "", device=None) -> BaseCaptioner:
    """The VLM captioner over a checkpoint directory, else the metadata
    captioner (module doc)."""
    if model_dir and Path(model_dir).is_dir():
        dev = resolve_device(device)
        try:
            return HuggingFaceVLMCaptioner(model_dir, device=dev)
        except Exception as exc:
            logger.warning("VLM captioner unavailable (%s); using metadata captioner", exc)
    return MetadataCaptioner()
