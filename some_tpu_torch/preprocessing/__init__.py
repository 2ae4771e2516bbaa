"""Port of ``some_tpu/preprocessing``: the binarizers, and ``binarizer_cls``
resolved by name."""
from some_tpu_torch.preprocessing.base_binarizer import BaseBinarizer, BinarizationError  # noqa: F401
from some_tpu_torch.preprocessing.me_binarizer import MIDIExtractionBinarizer
from some_tpu_torch.preprocessing.me_quant_binarizer import QuantizedMIDIExtractionBinarizer

# binarizer_cls, under the JAX package's names (some_tpu/registry.py) and the
# port's own module paths (what a spawned worker is given) -> the binarizer
BINARIZERS = {
    "preprocessing.MIDIExtractionBinarizer": MIDIExtractionBinarizer,
    "some_tpu.preprocessing.me_binarizer.MIDIExtractionBinarizer": MIDIExtractionBinarizer,
    "some_tpu_torch.preprocessing.me_binarizer.MIDIExtractionBinarizer":
        MIDIExtractionBinarizer,
    "preprocessing.QuantizedMIDIExtractionBinarizer": QuantizedMIDIExtractionBinarizer,
    "some_tpu.preprocessing.me_quant_binarizer.QuantizedMIDIExtractionBinarizer":
        QuantizedMIDIExtractionBinarizer,
    "some_tpu_torch.preprocessing.me_quant_binarizer.QuantizedMIDIExtractionBinarizer":
        QuantizedMIDIExtractionBinarizer,
}


def binarizer_class(name: str) -> type:
    if name not in BINARIZERS:
        raise ValueError(f"no binarizer for {name!r}")
    return BINARIZERS[name]
