from facerecognizeonnx_tpu_torch.io.imageio import VideoSource, imread, imwrite

__all__ = ["imread", "imwrite", "VideoSource"]
