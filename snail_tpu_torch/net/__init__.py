"""Network layer (``snail_tpu.net``): the tile codec and the client/server
frame protocol, host code with no framework, kept as the port's own
copies (the rebuild of the reference's comm/compression stack, SURVEY.md
§2.5)."""
