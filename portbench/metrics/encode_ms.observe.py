"""encode_ms.observe (ms): the mean host span of
`GlobalSceneEncoder.encode_observation` over the window's observations (its
numpy latent makes it synchronous)."""


def read(run):
    spans = getattr(run, "spans", {}).get("encode", [])
    return 1e3 * sum(spans) / len(spans) if spans else None
