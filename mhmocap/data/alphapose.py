"""AlphaPose/PoseFlow tracking post-processing (host-side).

Capability parity with reference `mhmocap/alphapose.py`: parses the
`alphapose-results.json` contract (§2.4 of the survey; list of dicts
with image_id / category_id / keypoints(17x3 COCO) / idx track id,
alphapose.py:8-55) and reconciles fragmented track ids into one fixed
(T, N, 17, 3) array with velocity-gated Hungarian re-assignment of
lost tracklets (alphapose.py:119-262).

This stage is string/dict-heavy bookkeeping that runs once per
sequence — it stays on the host by design; its (T, N, ...) output is
what gets sent to the device.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
from scipy.optimize import linear_sum_assignment

from .assignment import (SENTINEL_DISTANCE, match_pose_sets,
                         pose_distance_2d)


def load_tracking_results(
    track_file: str,
    image_ids=None,
    coef_thr: float = 0.5,
    min_size: Optional[float] = None,
    ignore_tracking: bool = False,
) -> Dict:
    """Parse an AlphaPose results JSON into {image_id: {track_id: pose}}.

    Filtering mirrors the reference (alphapose.py:8-55): category 1
    (person) only; at least two joints above `coef_thr`; optional
    minimum bbox side `min_size` over confident joints. With
    `ignore_tracking` every detection gets a fresh id (used for the
    optional HRNet pose override stream).
    """
    with open(track_file, "r") as f:
        data = json.load(f)

    out: Dict = {}
    fresh_idx = 0
    for det in data:
        if det.get("category_id", 1) != 1:
            continue
        img_id = det["image_id"]
        if image_ids is not None and img_id not in image_ids:
            continue
        pose = np.asarray(det["keypoints"], np.float32).reshape(-1, 3)
        conf = pose[:, 2]
        if np.sum(conf > coef_thr) < 2:
            continue
        if min_size is not None:
            valp = pose[conf > coef_thr]
            size = max(valp[:, 0].max() - valp[:, 0].min(),
                       valp[:, 1].max() - valp[:, 1].min())
            if size <= min_size:
                continue
        frame = out.setdefault(img_id, {})
        if ignore_tracking:
            frame[fresh_idx] = pose
            fresh_idx += 1
        else:
            frame[det["idx"]] = pose
    return out


def merge_pose_streams(annot: Dict, new_annot: Dict) -> Dict:
    """Overwrite tracked poses with matched poses from a second
    detector stream (reference update_pose_results, alphapose.py:58-75).

    Reference quirk reproduced: every Hungarian pair is applied
    unconditionally — including sentinel-cost pairs with no mutually
    visible joint (the reference applies all pairs from
    linear_kpts_assignment the same way).
    """
    for img_key, frame in annot.items():
        if img_key not in new_annot:
            continue
        keys = list(frame.keys())
        ref = np.stack([frame[k] for k in keys])
        new = np.stack(list(new_annot[img_key].values()))
        ref_idx, new_idx = match_pose_sets(ref, new, thr=0.25)
        for r, n in zip(ref_idx, new_idx):
            frame[keys[r]] = new[n]
    return annot


def _update_velocity(curr, prev, velocity, decay=0.9, momentum=0.5):
    """EMA of per-person 2D velocity; decays when unmatched
    (reference update_pose_velocity_2d, alphapose.py:78-98)."""
    mask = ((curr[:, 2] > 0.5) & (prev[:, 2] > 0.5)).astype(np.float32)
    if mask.sum() > 0:
        vel = (mask[:, None] * (curr[:, :2] - prev[:, :2])).sum(0) \
            / max(mask.sum(), 1)
        return momentum * velocity + (1.0 - momentum) * vel
    return decay * velocity


def tracks_to_array(
    annot: Dict,
    frame_ids=None,
    max_num_people: Optional[int] = None,
    verbose: bool = False,
    image_names=None,
    id_swap_fix: float = 0.0,
) -> np.ndarray:
    """Reconcile fragmented tracklets into a dense (T, N, 17, 3) array.

    Behavioral parity with reference preprocess_alphapose_predictions
    (alphapose.py:119-262):
      * frame 0 seeds slot assignments from sorted track ids;
      * later frames first consume detections whose track id is
        already mapped to a slot;
      * when detections run out while slots are empty, stale mappings
        for those slots are dropped (AlphaPose reuses ids across
        people);
      * leftover detections are Hungarian-matched to the last valid
        pose of each empty slot, accepted only inside a velocity-gated
        tracking region (3 * dt * |velocity|).

    Reference quirks: (1) a slot whose velocity EMA is zero (never
    matched, or fully decayed) has a zero-width re-acquisition gate
    and can only be recovered through its track id, exactly as in the
    reference's `3 * delta_t * |velocity|` test (reproduced). (2) The
    reference's time axis covers frames WITH surviving detections
    only (T = len(images_set), alphapose.py:149), so its final
    positional `pose2d[frame_ids]` slice SHIFTS the tail — and then
    indexes out of bounds — whenever any frame has zero surviving
    detections (total detector dropout). DELIBERATE DEVIATION for
    robustness: pass `image_names` (the full sorted frame-key list
    from the image directory) and absent frames become zero-confidence
    rows at their correct positions instead; gap-free inputs (every
    reference-valid input) are bit-identical either way. Without
    `image_names` the reference's present-frames-only axis is kept.

    `id_swap_fix` (default 0.0 = off = reference parity) is an opt-in
    robustness extension: a SUSTAINED tracker identity switch (two
    people's track ids swap in the JSON) rides straight through the
    known-id fast path above — the velocity gate only guards EMPTY
    slots, so the reference anchors each person to the OTHER person's
    2D evidence for the whole span (measured on the degraded sweep:
    the switch-in/out transients carry most of the sequence's jitter,
    docs/PARITY.md). With a ratio r in (0, 1), each frame's id-assigned
    group is Hungarian-checked against the last-seen poses of their
    own slots PLUS the currently-empty slots — a switch that lands on
    the same frame as a detection dropout presents as ONE mis-id'd
    detection whose true home is the empty slot, not as a permutation
    — and the optimal re-routing replaces the id assignment only when
    its total pose distance is < r * the id assignment's total, so
    genuine crossings (near-tie distances) never flap. Pairs with NO
    mutually confident joint carry the 99999 no-shared-joints sentinel
    from `pose_distance_2d`; a sentinel in either side of the margin
    test makes the ratio meaningless (an id-correct detection whose
    visible joints are disjoint from its own slot's last-seen pose
    would inflate id_cost until any finite permutation "wins"), so the
    correction is skipped — the id assignment stands — whenever a
    sentinel enters id_cost or opt_cost. Track-id
    mappings follow the correction (evicting stale mappings of the
    re-routed slots), so a sustained swap is fixed once at switch-in
    (and once more at switch-out, when the JSON swaps back); the slot
    a correction vacates re-acquires its person through the normal
    velocity-gated Hungarian below.
    """
    annot = {k: dict(v) for k, v in annot.items()}  # shallow copy
    images = sorted(annot.keys())
    all_ids = sorted({pid for frame in annot.values() for pid in frame})

    T = len(images)
    if max_num_people is not None:
        N = min(len(all_ids), max_num_people)
    else:
        N = max((len(annot[k]) for k in images), default=0)
        if verbose:
            print(f"alphapose: max {N} detections per frame")

    pose2d = np.zeros((T, N, 17, 3), np.float32)
    last_seen = np.zeros((N,), int)
    velocity = np.zeros((N, 2), np.float32)
    slot_of: Dict = {}  # track id -> slot

    for t, img_key in enumerate(images):
        frame = annot[img_key]
        tracked = np.zeros((N,), int)

        if t == 0:
            keys = sorted(frame.keys())
            ik = -1
            for ik in range(min(N, len(keys))):
                slot_of[keys[ik]] = ik
                pose2d[t, ik] = frame[keys[ik]]
                last_seen[ik] = t
                tracked[ik] = 1
            # reserve ids for slots with no detection in frame 0
            next_id = keys[ik] + 1 if keys else 0
            for ik2 in range(ik + 1, N):
                slot_of[next_id] = ik2
                next_id += 1
            continue

        # 1. known track ids
        id_assigned = [(pid, slot_of[pid]) for pid in list(slot_of)
                       if pid in frame]
        target = [n for _, n in id_assigned]
        if id_swap_fix > 0.0 and id_assigned:
            # opt-in identity-switch correction (see docstring): trust
            # positions over ids only when the optimal re-routing of
            # the id-assigned detections — over their own slots PLUS
            # the currently-empty slots' last-seen poses (a switch
            # that coincides with a dropout leaves the displaced
            # person's slot empty) — beats the id assignment by the
            # ratio margin
            K = len(id_assigned)
            own = [n for _, n in id_assigned]
            slots = own + [n for n in range(N) if n not in own]
            dets = [np.asarray(frame[pid], np.float32)
                    for pid, _ in id_assigned]
            refs = [pose2d[last_seen[n], n] for n in slots]
            cost = np.empty((K, len(slots)), np.float32)
            for i in range(K):
                for j in range(len(slots)):
                    cost[i, j] = pose_distance_2d(dets[i], refs[j])
            _, cols = linear_sum_assignment(cost)
            diag = cost[np.arange(K), np.arange(K)]
            chosen = cost[np.arange(K), cols]
            id_cost = float(diag.sum())
            opt_cost = float(chosen.sum())
            # the 99999 no-shared-joints sentinel makes the margin
            # test meaningless (see docstring): skip the correction
            # when it enters either total
            no_sentinel = (float(diag.max()) < SENTINEL_DISTANCE
                           and float(chosen.max()) < SENTINEL_DISTANCE)
            if (not np.array_equal(cols, np.arange(K))
                    and id_cost > 0.0 and no_sentinel
                    and opt_cost < id_swap_fix * id_cost):
                target = [slots[c] for c in cols]
                # re-routed slots: evict every stale mapping first so
                # a reused id can't shadow the correction, then remap
                # the group's ids to where their detections landed
                for n in target:
                    for pid in [p for p, s in slot_of.items()
                                if s == n]:
                        del slot_of[pid]
                for (pid, _), n in zip(id_assigned, target):
                    slot_of[pid] = n
        for (pid, _), n in zip(id_assigned, target):
            pose2d[t, n] = frame[pid]
            velocity[n] = _update_velocity(
                pose2d[t, n], pose2d[t - 1, n], velocity[n])
            last_seen[n] = t
            tracked[n] = 1
            del frame[pid]

        if tracked.min() == 1:
            continue

        if len(frame) == 0:
            # 2.1 lost slots with nothing left to assign: drop their
            # mapping so a reused id can't hijack them later.
            for n in np.arange(N)[tracked == 0]:
                for pid in [p for p, s in slot_of.items() if s == n]:
                    del slot_of[pid]
            continue

        # 2.2 Hungarian re-assignment inside the tracking region
        empty = np.arange(N)[tracked == 0]
        prev_ref = np.stack([pose2d[last_seen[n], n] for n in empty])
        cand_keys = list(frame.keys())
        cands = np.stack([frame[k] for k in cand_keys])
        ref_idx, cand_idx = match_pose_sets(prev_ref, cands)
        for r, c in zip(ref_idx, cand_idx):
            n = empty[r]
            cand = frame[cand_keys[c]]
            dist = pose_distance_2d(cand, prev_ref[r])
            dt = t - last_seen[n]
            gate = 3.0 * dt * float(np.sqrt(np.sum(velocity[n] ** 2)))
            if dist < gate:
                pose2d[t, n] = cand
                last_seen[n] = t
                for pid in [p for p, s in slot_of.items() if s == n]:
                    del slot_of[pid]
                slot_of[cand_keys[c]] = n
                del frame[cand_keys[c]]

    if image_names is not None:
        # re-anchor the present-frames-only axis onto the caller's
        # full frame list: zero-detection frames become zero rows.
        # If the JSON's image_id scheme doesn't match the caller's
        # names at all, keep the positional axis (re-anchoring onto
        # nothing would zero every frame); a PARTIAL mismatch drops
        # the unmatched frames' detections, so it warns loudly.
        pos = {k: i for i, k in enumerate(image_names)}
        unmatched = [k for k in images if k not in pos]
        if not images or len(unmatched) < len(images):
            if unmatched:
                import warnings
                warnings.warn(
                    f"{len(unmatched)} of {len(images)} AlphaPose "
                    f"image_ids match no frame in the image directory "
                    f"(e.g. {unmatched[0]!r}); their detections are "
                    f"DROPPED by the full-frame re-anchoring.",
                    RuntimeWarning)
            full = np.zeros((len(image_names), N, 17, 3), np.float32)
            for t, img_key in enumerate(images):
                if img_key in pos:
                    full[pos[img_key]] = pose2d[t]
            pose2d = full
    if frame_ids is not None:
        pose2d = pose2d[np.asarray(frame_ids, int)]
    return pose2d
