"""The device<->cloud wire protocol (framing and payload codecs); the
plain Python decoder of the frames the native decoder reads."""
