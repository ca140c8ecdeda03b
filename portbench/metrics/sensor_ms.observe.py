"""sensor_ms.observe (ms): the mean host span of `PointCloudSensor.observe`
over the window's observations (its numpy result makes it synchronous)."""


def read(run):
    spans = getattr(run, "spans", {}).get("sensor", [])
    return 1e3 * sum(spans) / len(spans) if spans else None
