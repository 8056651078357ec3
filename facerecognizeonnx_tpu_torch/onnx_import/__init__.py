"""ONNX model import without onnxruntime or the onnx package.

Port of `facerecognizeonnx_tpu/onnx_import/`:

  proto.py      — a protobuf wire-format reader for the ONNX schema
                  subset (ModelProto / GraphProto / NodeProto /
                  TensorProto / AttributeProto)
  executor.py   — a graph executor running ONNX ops as torch ops on one
                  device, weights uploaded once
  importer.py   — OnnxRunner, an nn.Module with the native models' output
                  contracts, which plugs into the detect / embed pipelines
  native_map.py — recognizer .onnx files mapped onto the port's IResNet /
                  MobileFaceNet / ViT modules, self-verified
"""

from facerecognizeonnx_tpu_torch.onnx_import.importer import OnnxRunner, load_onnx_params

__all__ = ["OnnxRunner", "load_onnx_params"]
