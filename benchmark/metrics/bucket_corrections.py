"""Program-B reruns of the bucketed pipeline per 1,000 batches, counted
over the whole window (`BucketedEmbedPipeline.corrections / steps`)."""

UNIT = "per_1000"


def read(s):
    c = s.get("counters", {})
    if "corrections" not in c or not c.get("steps"):
        return None
    return 1000.0 * c["corrections"] / c["steps"]
