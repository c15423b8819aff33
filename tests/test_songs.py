"""Songs library: data sanity + event-code consistency across layers.

Reference: src/songs_lib.cpp (song definitions and numbering) and its
consumers — the MCL state machine plays 1/2 (monte_carlo.cpp:1041,1059)
and the mission layer plays 4 per gold, 5 at pickup
(executeChallenge.cpp:295-340).  The JAX rebuild has no speaker; parity is
that every layer emits the SAME song numbers against one shared library.
"""
import jax
import jax.numpy as jnp
import numpy as np

from montecarlolocalisation.config import FilterConfig, HysteresisConfig
from montecarlolocalisation.planning import mission
from montecarlolocalisation.utils import songs


def test_song_library_structure():
    # Five songs, numbered like songs_lib.cpp's store1..store5.
    assert set(songs.SONGS) == {1, 2, 3, 4, 5}
    for num, song in songs.SONGS.items():
        assert len(song) > 0
        for note, dur in song:
            assert 0 <= note <= 127, f"song {num}: bad MIDI note {note}"
            assert dur > 0, f"song {num}: bad duration {dur}"


def test_song_constants_consistent_across_layers():
    # The hysteresis config (MCLOutput.song producer) and the mission layer
    # must agree with the shared library's numbering.
    h = HysteresisConfig()
    assert h.song_lost == songs.SONG_LOST
    assert h.song_recovered == songs.SONG_RECOVERED
    assert mission.SONG_GOLD == songs.SONG_GOLD
    assert mission.SONG_PICKUP == songs.SONG_PICKUP


def test_reference_song_bytes_golden():
    # REFERENCE_SONG_BYTES must reproduce songs_lib.cpp's arrays byte for
    # byte (MEASURE=80 -> Q=20, Ed=15, S=5; songs_lib.cpp:7-10).
    assert (songs.Q, songs.Ed, songs.S) == (20, 15, 5)
    assert songs.REFERENCE_SONG_BYTES[1] == [57, 5, 62, 5]
    assert songs.REFERENCE_SONG_BYTES[2] == [62, 5, 67, 20, 67, 5, 67, 5, 65, 20]
    assert songs.REFERENCE_SONG_BYTES[3] == [57, 20, 57, 20, 57, 20, 62, 20]
    assert songs.REFERENCE_SONG_BYTES[4] == [
        62, 20, 64, 20, 67, 20, 64, 20, 71, 15, 71, 20, 69, 20,
        62, 20, 64, 20, 67, 20, 64, 20, 69, 15, 69, 20, 67, 20]
    # store5: each source line ends with a bare `g4,` (songs_lib.cpp:100-105)
    # so the flat array is 4 x 17 = 68 bytes and the (note, duration) pairing
    # shifts from the 9th pair on — preserved verbatim.
    raw5 = songs.REFERENCE_SONG_BYTES[5]
    assert len(raw5) == 68
    line1 = [62, 20, 64, 20, 67, 15, 67, 15, 67, 15, 67, 5, 67, 5, 67, 5, 67]
    line2 = [62, 15, 64, 15, 67, 5, 67, 5, 67, 5, 67, 5, 67, 5, 67, 5, 67]
    assert raw5 == line1 + line2 + line1 + line2
    # The pairing-shift quirk: pair 9 is (note g4, "duration" d4=62).
    assert (raw5[16], raw5[17]) == (67, 62)


def test_store_song_opcode_frames():
    # OI "Song" frame: [140, number, n_notes, note1, dur1, ...].
    assert songs.encode_store_song(1) == bytes([140, 1, 2, 57, 5, 62, 5])
    assert songs.encode_store_song(3) == bytes(
        [140, 3, 4, 57, 20, 57, 20, 57, 20, 62, 20])
    f4 = songs.encode_store_song(4)
    assert f4[:3] == bytes([140, 4, 14]) and len(f4) == 3 + 28
    # store5's 34 pairs exceed the OI 16-note capacity -> truncated to 16.
    f5 = songs.encode_store_song(5)
    assert f5[:3] == bytes([140, 5, 16]) and len(f5) == 3 + 32
    assert list(f5[3:]) == songs.REFERENCE_SONG_BYTES[5][:32]


def test_play_song_opcode_and_upload_order():
    assert songs.encode_play_song(2) == bytes([141, 2])
    frames = songs.upload_opcodes()
    # uploadSongs calls the service for 5, 4, 1, 2, 3 in that order
    # (songs_lib.cpp:108-136).
    assert [f[1] for f in frames] == [5, 4, 1, 2, 3]
    for f in frames:
        assert f[0] == 140 and f[2] == (len(f) - 3) // 2


def test_song_events_filters_zero_ticks():
    codes = [0, 0, songs.SONG_LOST, 0, songs.SONG_RECOVERED, 0]
    assert songs.song_events(codes) == [(2, songs.SONG_LOST),
                                        (4, songs.SONG_RECOVERED)]
    assert songs.song_events(np.zeros(5, np.int32)) == []
    # Accepts device arrays (an episode's MCLOutput.song stream).
    assert songs.song_events(jnp.asarray([0, 3], jnp.int32)) == [(1, 3)]


def test_filter_emits_lost_song_on_transition(default_map):
    # Drive the hysteresis directly: a confident state whose confidence
    # drops below threshold must emit song 1 + wanderer start, exactly once
    # (the reference plays the song only on the TRANSITION tick,
    # monte_carlo.cpp:1035-1045).
    from montecarlolocalisation.models import filter as mcl

    cfg = FilterConfig(num_particles=128)
    state = mcl.init_state(jax.random.PRNGKey(0), default_map, cfg)
    state = mcl.MCLState(
        **{**{f.name: getattr(state, f.name)
              for f in state.__dataclass_fields__.values()},
           "confidence": jnp.float32(0.1),
           "confident_threshold": jnp.float32(0.5),
           "was_lost": jnp.bool_(False)})
    was_lost, _, _, song, wanderer = mcl._hysteresis(state, default_map, cfg)
    assert bool(was_lost)
    assert int(song) == songs.SONG_LOST
    assert int(wanderer) == mcl.WANDERER_START
    # Second tick, still lost: no re-trigger.
    state2 = mcl.MCLState(
        **{**{f.name: getattr(state, f.name)
              for f in state.__dataclass_fields__.values()},
           "was_lost": jnp.bool_(True)})
    _, _, _, song2, _ = mcl._hysteresis(state2, default_map, cfg)
    assert int(song2) == 0
