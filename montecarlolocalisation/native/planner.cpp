// Native host-side planner: BFS over the maze wall graph + Held-Karp TSP.
//
// Host-side counterpart of the reference's C++ planning nodes:
//   * graph building / BFS: moveToPosition_server.cpp:185-264
//     (buildGraphFromWallArray + bfs) — direction deltas RIGHT=(0,+1),
//     TOP=(-1,0), LEFT=(0,-1), BOTTOM=(+1,0); a neighbor exists when the
//     direction code is absent from the cell's wall list and in bounds.
//   * Held-Karp: executeChallenge.cpp:190-247 (tsp_held_karp) — exact
//     bitmask DP from node 0, tour does NOT return to start, but the final
//     node is selected by dp[last][i] + dist[i][0] exactly as the reference
//     does.
//
// Planning is microscopic next to the filter, but it sits on the host hot
// path of closed-loop missions, so it stays native C++ (ctypes ABI; no
// pybind11 dependency).  Build: see native/build.py.
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

constexpr int kDRow[4] = {0, -1, 0, 1};  // RIGHT, TOP, LEFT, BOTTOM
constexpr int kDCol[4] = {1, 0, -1, 0};

inline bool has_wall(const uint8_t* walls, int cols, int r, int c, int d) {
  return walls[(r * cols + c) * 4 + d] != 0;
}

}  // namespace

extern "C" {

// BFS shortest path on the wall graph.
// walls: [rows*cols*4] uint8 wall tensor (1 = wall present).
// out_path: caller buffer of capacity max_len (row, col) int32 pairs.
// Returns number of nodes in the path (including start), 0 if unreachable,
// -1 on bad args.
int32_t mcl_bfs_path(const uint8_t* walls, int32_t rows, int32_t cols,
                     int32_t start_r, int32_t start_c, int32_t goal_r,
                     int32_t goal_c, int32_t* out_path, int32_t max_len) {
  if (rows <= 0 || cols <= 0) return -1;
  if (start_r < 0 || start_r >= rows || start_c < 0 || start_c >= cols)
    return -1;
  if (goal_r < 0 || goal_r >= rows || goal_c < 0 || goal_c >= cols) return -1;
  const int n = rows * cols;
  std::vector<int32_t> parent(n, -2);  // -2 unvisited, -1 root
  std::queue<int32_t> q;
  const int32_t start = start_r * cols + start_c;
  const int32_t goal = goal_r * cols + goal_c;
  parent[start] = -1;
  q.push(start);
  while (!q.empty()) {
    int32_t cur = q.front();
    q.pop();
    if (cur == goal) break;
    const int r = cur / cols, c = cur % cols;
    for (int d = 0; d < 4; ++d) {
      if (has_wall(walls, cols, r, c, d)) continue;
      const int nr = r + kDRow[d], nc = c + kDCol[d];
      if (nr < 0 || nr >= rows || nc < 0 || nc >= cols) continue;
      const int32_t nxt = nr * cols + nc;
      if (parent[nxt] != -2) continue;
      parent[nxt] = cur;
      q.push(nxt);
    }
  }
  if (parent[goal] == -2) return 0;
  std::vector<int32_t> rev;
  for (int32_t node = goal; node != -1; node = parent[node])
    rev.push_back(node);
  const int32_t len = static_cast<int32_t>(rev.size());
  if (out_path != nullptr) {
    const int32_t m = len < max_len ? len : max_len;
    for (int32_t i = 0; i < m; ++i) {
      const int32_t node = rev[len - 1 - i];
      out_path[2 * i] = node / cols;
      out_path[2 * i + 1] = node % cols;
    }
  }
  return len;
}

// All-pairs BFS node-count distances for a node list (the generateTSPGraph
// pattern, executeChallenge.cpp:148-186).  nodes: [n*2] (row, col).
// out_dist: [n*n] int32 path node counts (0 = unreachable).
int32_t mcl_bfs_all_pairs(const uint8_t* walls, int32_t rows, int32_t cols,
                          const int32_t* nodes, int32_t n,
                          int32_t* out_dist) {
  for (int32_t i = 0; i < n; ++i) {
    for (int32_t j = 0; j < n; ++j) {
      out_dist[i * n + j] = mcl_bfs_path(
          walls, rows, cols, nodes[2 * i], nodes[2 * i + 1], nodes[2 * j],
          nodes[2 * j + 1], nullptr, 0);
    }
  }
  return 0;
}

// Held-Karp exact TSP from node 0, open tour (no return), final node chosen
// by cost + dist-back-to-0 (executeChallenge.cpp:219-226 reference quirk).
// dist: [n*n] int32, out_order: [n] visiting order (starts with 0).
// Returns tour cost, or -1 for n < 1 or n > 20.
int64_t mcl_held_karp(const int32_t* dist, int32_t n, int32_t* out_order) {
  if (n < 1 || n > 20) return -1;
  if (n == 1) {
    out_order[0] = 0;
    return 0;
  }
  const int64_t INF = (int64_t)1e15;
  const int32_t full = 1 << n;
  std::vector<int64_t> dp((size_t)full * n, INF);
  std::vector<int32_t> parent((size_t)full * n, -1);
  dp[1 * n + 0] = 0;
  for (int32_t mask = 1; mask < full; ++mask) {
    for (int32_t u = 0; u < n; ++u) {
      if (!(mask & (1 << u)) || dp[(size_t)mask * n + u] >= INF) continue;
      for (int32_t v = 0; v < n; ++v) {
        if (mask & (1 << v)) continue;
        const int32_t nxt = mask | (1 << v);
        const int64_t cost = dp[(size_t)mask * n + u] + dist[u * n + v];
        if (cost < dp[(size_t)nxt * n + v]) {
          dp[(size_t)nxt * n + v] = cost;
          parent[(size_t)nxt * n + v] = u;
        }
      }
    }
  }
  int64_t best = INF;
  int32_t last = -1;
  for (int32_t i = 1; i < n; ++i) {
    const int64_t cost = dp[(size_t)(full - 1) * n + i] + dist[i * n + 0];
    if (cost < best) {
      best = cost;
      last = i;
    }
  }
  // Reconstruct (open path; the dist-back term above only picks the winner).
  std::vector<int32_t> rev;
  int32_t mask = full - 1, cur = last;
  while (cur != 0) {
    rev.push_back(cur);
    const int32_t prev = parent[(size_t)mask * n + cur];
    mask ^= (1 << cur);
    cur = prev;
  }
  out_order[0] = 0;
  for (size_t i = 0; i < rev.size(); ++i)
    out_order[i + 1] = rev[rev.size() - 1 - i];
  return best - dist[last * n + 0];
}

}  // extern "C"
