"""Vision side of the Sensor/Encoder bridge (port of pointcloud_tpu/vision;
reference: pc_sensor.py, pc_encoder.py): point-cloud sensing and
trained-model encoders, on the env's device."""
