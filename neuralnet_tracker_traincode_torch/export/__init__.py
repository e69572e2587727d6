"""Export for the opentrack plugin: the ONNX writer (`onnx_proto.py`,
`onnx_export.py`), its conformance check (`onnx_conformance.py`) and the
torch executor of the written files (`onnx_run.py`)."""
