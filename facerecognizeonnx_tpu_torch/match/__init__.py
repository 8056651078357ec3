"""Similarity matching of features, and the 1:N gallery."""

from facerecognizeonnx_tpu_torch.match.similarity import compare_faces, similarity_matrix

__all__ = ["compare_faces", "similarity_matrix", "GalleryBank"]


def __getattr__(name):
    if name == "GalleryBank":
        from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank

        return GalleryBank
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
