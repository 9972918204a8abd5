"""setup_s: seconds from process start to the first step of the window
(import, kernel build or load, scene, the first 600 steps)."""


def read(raw: dict):
    return raw["setup_s"]
