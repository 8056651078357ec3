"""Device-side image/geometry ops: letterbox, normalize, NMS, Umeyama, warps."""
